"""``chip_smoke.py``'s phase 12 alone: the data-parallel fit and the
station-sharded classify in ranks beside the same work in one process, on
phase 7's synthetic pool and the bench stream.

    python3 scripts/mesh_phase.py

(a) NCCL over every card of the machine, one rank a card; (b) two gloo ranks
on cuda:0. The checks and printed numbers are the phase's.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    from volpick_tpu_torch.data.synthetic import synthetic_arrays
    from volpick_tpu_torch.picker.stage_times import bench_stream_array, smi

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)} ({smi('name,power.limit')})"
    print(f"{torch.cuda.device_count()} x {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    waves, meta = synthetic_arrays(n_events=chip_smoke.TRAIN_EVENTS, n_noise=chip_smoke.TRAIN_NOISE,
                                   n_samples=chip_smoke.TRAIN_SAMPLES, seed=0)
    out = chip_smoke.mesh_phase(torch.device("cuda", 0), card, waves, meta, bench_stream_array(seed=0))
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
