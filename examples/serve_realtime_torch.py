"""Demo: real-time serving loop with the PyTorch port's StreamingPicker.

The counterpart of ``examples/serve_realtime.py`` on ``volpick_tpu_torch``:
a simulated telemetry feed (1-second packets per station and component, the
shape of a SeedLink/Earthworm consumer) goes into ``StreamingPicker.ingest``,
and picks are printed the moment they are final. At the end the streamed
picks are held against an offline ``classify()`` over the same records.

Published weights are taken where they are found (``$VOLPICK_TPU_MODELS``,
``~/.cache/volpick_tpu/models``); otherwise the model is seeded
(``load_model(arch, seed=0)``), whose picks mean nothing but exercise the
same path.

Run: python examples/serve_realtime_torch.py [--arch phasenet] [--device cpu]
The device defaults to the GPU.
"""

import argparse

import numpy as np

from volpick_tpu_torch.core import UTC, Stream, Trace
from volpick_tpu_torch.models import from_pretrained, load_model
from volpick_tpu_torch.picker import StreamingPicker, WaveformPicker

SR = 100.0
PACKET_S = 1.0
DURATION_S = 300.0
T0 = UTC("2026-01-01T00:00:00")


def synthetic_day_feed():
    """(station, 3, n) arrays with known event onsets."""
    rng = np.random.default_rng(11)
    feeds = {}
    for sta, events in (("VOL1", (65.0, 190.0)), ("VOL2", (128.0,))):
        n = int(DURATION_S * SR)
        t = np.arange(n) / SR
        d = rng.normal(size=(3, n)) * 0.05
        for p_at in events:
            env = np.where(t >= p_at, np.exp(-(t - p_at) / 2.0), 0)
            d[0] += np.sin(2 * np.pi * 8 * t) * env * 2
            env_s = np.where(t >= p_at + 3.5, np.exp(-(t - p_at - 3.5) / 3.0), 0)
            d[1] += np.sin(2 * np.pi * 4 * t) * env_s * 3
            d[2] += np.sin(2 * np.pi * 4 * t) * env_s * 2.5
        feeds[sta] = d.astype(np.float32)
    return feeds


def packets(feeds):
    """Yield packets in arrival order: every second, one per station/comp."""
    npkt = int(PACKET_S * SR)
    n = int(DURATION_S * SR)
    for lo in range(0, n, npkt):
        for sta, d in feeds.items():
            for ci, comp in enumerate("ZNE"):
                yield Trace(
                    d[ci, lo : lo + npkt],
                    dict(network="XX", station=sta, channel=f"HH{comp}",
                         sampling_rate=SR, starttime=T0 + lo / SR),
                )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phasenet",
                    help="phasenet, eqtransformer, voleqtransformer or tpupicknet")
    ap.add_argument("--device", default=None, help='"cpu" or a CUDA device; the GPU when omitted')
    args = ap.parse_args()
    seeded = False
    try:
        model = from_pretrained(args.arch, device=args.device)
    except FileNotFoundError:
        seeded = True
        print(f"[{args.arch}] pretrained weights not found: a seeded model instead")
        model = load_model(args.arch, seed=0, device=args.device)
    picker = WaveformPicker(model, device=args.device)
    live = StreamingPicker(picker, hop_seconds=15.0)

    feeds = synthetic_day_feed()
    streamed = []
    for pkt in packets(feeds):
        for p in live.ingest(pkt):
            lag = (pkt.stats.starttime + PACKET_S) - p.peak_time
            print(f"[live +{(pkt.stats.starttime - T0) + PACKET_S:6.1f}s] "
                  f"{p.phase} pick {p.trace_id} at {p.peak_time.isoformat()} "
                  f"(prob {p.peak_value:.2f}, finalized {lag:.1f}s after onset)")
            streamed.append(p)
    streamed.extend(live.flush())  # drain picks still inside the live margin

    # offline reference pass over the identical records
    st = Stream([
        Trace(d[ci], dict(network="XX", station=sta, channel=f"HH{c}",
                          sampling_rate=SR, starttime=T0))
        for sta, d in feeds.items() for ci, c in enumerate("ZNE")
    ])
    offline = picker.classify(st, overlap=live.overlap, blinding=live.blinding).picks
    match = {(p.trace_id, p.phase, round(p.peak_time.timestamp, 2)) for p in streamed} == \
            {(p.trace_id, p.phase, round(p.peak_time.timestamp, 2)) for p in offline}
    print(f"\n{len(streamed)} streamed picks on {picker.device}; offline classify agrees: {match}"
          + (" (a seeded model's curves are nearly flat, its trigger runs minutes long and cut by "
             "every pass: agreement is what trained weights give)" if seeded else ""))


if __name__ == "__main__":
    main()
