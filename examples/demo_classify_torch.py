"""Demo: pick P/S phases on a stream with the PyTorch port.

The counterpart of ``examples/demo_classify.py`` on ``volpick_tpu_torch``:
    picker = WaveformPicker(from_pretrained("eqtransformer"))
    output = picker.classify(stream, overlap=5500, blinding=(500, 500))

A synthetic 2-station stream with known events is picked by PhaseNet and by
EQTransformer. Published weights are taken where they are found
(``$VOLPICK_TPU_MODELS``, ``~/.cache/volpick_tpu/models``); otherwise the
model is seeded (``load_model(arch, seed=0)``), whose picks mean nothing but
exercise the same path. (Reading miniSEED files is not part of the port yet.)

Run: python examples/demo_classify_torch.py [--device cpu]
The device defaults to the GPU.
"""

import argparse

import numpy as np

from volpick_tpu_torch.core import UTC, Stream, Trace
from volpick_tpu_torch.models import from_pretrained, load_model
from volpick_tpu_torch.picker import WaveformPicker


def synthetic_stream():
    rng = np.random.default_rng(7)
    traces = []
    for sta, events in (("DEMO1", (60.0, 180.0)), ("DEMO2", (120.0,))):
        n = 30000  # 5 min @ 100 Hz
        t = np.arange(n) / 100.0
        d = rng.normal(size=(3, n)) * 0.05
        for p_at in events:
            env = np.where(t >= p_at, np.exp(-(t - p_at) / 2.0), 0)
            d[0] += np.sin(2 * np.pi * 8 * t) * env * 2
            env_s = np.where(t >= p_at + 3.5, np.exp(-(t - p_at - 3.5) / 3.0), 0)
            d[1] += np.sin(2 * np.pi * 4 * t) * env_s * 3
            d[2] += np.sin(2 * np.pi * 4 * t) * env_s * 2.5
        for i, c in enumerate("ZNE"):
            traces.append(
                Trace(d[i], dict(network="XX", station=sta, channel=f"BH{c}",
                                 sampling_rate=100.0, starttime=UTC("2024-01-01")))
            )
    return Stream(traces)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help='"cpu" or a CUDA device; the GPU when omitted')
    args = ap.parse_args()
    stream = synthetic_stream()

    for arch, kwargs in (
        ("phasenet", dict(overlap=2500, blinding=(500, 500))),
        ("eqtransformer", dict(overlap=5500, blinding=(500, 500), batch_size=256)),
    ):
        try:
            model = from_pretrained(arch, device=args.device)
        except FileNotFoundError:
            print(f"[{arch}] pretrained weights not found: a seeded model instead")
            model = load_model(arch, seed=0, device=args.device)
        picker = WaveformPicker(model, device=args.device)
        output = picker.classify(stream, **kwargs)
        print(f"\n=== {arch} on {picker.device}, phases {picker.phases} ===")
        print(output)
        for p in output.picks[:20]:
            print(" ", p)
        for d in output.detections[:10]:
            print("  DET", d)


if __name__ == "__main__":
    main()
