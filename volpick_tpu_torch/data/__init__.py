"""Waveform datasets of the port: the SeisBench HDF5+CSV reader and writer and
the synthetic generators (copies of ``volpick_tpu/data``'s modules)."""
