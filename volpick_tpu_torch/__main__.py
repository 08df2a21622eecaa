"""Command-line interface: `python -m volpick_tpu_torch <command>`.

Commands
--------
train     train from a JSON config (same as python -m volpick_tpu_torch.train.trainer)
targets   generate task0/task1/task23 evaluation target CSVs for a dataset
evaluate  run the task0 threshold sweep + task1/2/3 scoring

`train` and `evaluate` run on the card unless given `--device cpu`. Reading a
dataset directory needs h5py and pandas.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_train(args):
    from volpick_tpu_torch.train.trainer import main as train_main

    argv = ["--config", args.config]
    if args.test_run:
        argv.append("--test_run")
    if args.device is not None:
        argv += ["--device", args.device]
    return train_main(argv)


def _cmd_targets(args):
    from volpick_tpu_torch.data.dataset import load_dataset
    from volpick_tpu_torch.eval import generate_task0, generate_task1, generate_task23

    ds = load_dataset(args.data)
    generate_task0(ds, args.output, noise_before_events=True)
    generate_task1(ds, args.output, noise_before_events=True)
    generate_task23(ds, args.output)
    print(f"targets -> {args.output}")


def _cmd_evaluate(args):
    from volpick_tpu_torch.data.dataset import load_dataset
    from volpick_tpu_torch.eval import eval_task0, eval_tasks123, opt_prob_metrics, parse_task1, parse_task23
    from volpick_tpu_torch.models import from_pretrained

    ds = load_dataset(args.data)
    model = from_pretrained(args.model, args.weights, device=args.device)
    eval_task0(model, ds, args.targets, args.output, batch_size=args.batch_size, device=args.device)
    eval_tasks123(model, ds, args.targets, args.output, batch_size=args.batch_size, device=args.device)
    stats = {}
    stats.update(opt_prob_metrics(args.output))
    stats.update(parse_task1(args.output))
    stats.update(parse_task23(args.output))
    print(json.dumps({k: (float(v) if hasattr(v, "item") else v) for k, v in stats.items()},
                     indent=2, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="volpick_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)
    device_help = '"cuda" (the default: the card) or "cpu"'

    p = sub.add_parser("train", help="train from a JSON config")
    p.add_argument("--config", required=True)
    p.add_argument("--test_run", action="store_true")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("targets", help="generate evaluation target CSVs")
    p.add_argument("--data", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=_cmd_targets)

    p = sub.add_parser("evaluate", help="run the evaluation harness")
    p.add_argument("--data", required=True)
    p.add_argument("--targets", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", default="phasenet")
    p.add_argument("--weights", default="volpick")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=_cmd_evaluate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
