"""Median over the slice's requests of the device's idle ms inside each
request's root ``classify`` span: the idle the program holds the device in."""

from benchmark import spans


def read(ctx):
    return spans.read_held_idle_ms(ctx)
