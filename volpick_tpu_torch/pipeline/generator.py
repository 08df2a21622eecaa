"""Host-side batch assembly feeding the augmentation program on the device.

Port of ``volpick_tpu/pipeline/generator.py`` (``PHASE_COLUMNS``,
``_onset_arrays``, ``select_window_offsets_host``, ``host_window_crop``,
``device_gather_crop``, ``RawBatchSource``, ``TrainGenerator``). The host
keeps the raw traces in numpy buffers, draws shuffled indices and window
offsets from ``np.random.default_rng(seed)`` in the JAX generator's order
(so indices, offsets and host crops equal the JAX package's exactly), and
hands fixed-shape batches to ``augmentations.augment_train_batch`` on the
generator's device. In the device-resident mode the trace pools are uploaded
once and only indices and offsets cross to the device each step. A producer
thread prepares the next batches while the consumer trains.

``pandas`` is imported only where metadata is read from a dataset;
``RawBatchSource.from_arrays`` builds a source from arrays in memory.

The evaluation harness (``eval/``) frames its windows with the steered
helpers at the end: ``steered_window_offsets`` places each window on the
host, ``steered_frames`` cuts and conditions them on the device, and
``eval_batch`` is the per-trace numpy version of both, their reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from volpick_tpu_torch.device import resolve_device
from volpick_tpu_torch.ops.signal import demean, detrend_linear, normalize_amplitude
from volpick_tpu_torch.pipeline.augmentations import AugmentConfig, augment_train_batch, draw_augment

# metadata column → phase map (reference `volpick/model/models.py:26-31`)
PHASE_COLUMNS = {
    "trace_p_arrival_sample": "P",
    "trace_P_arrival_sample": "P",
    "trace_s_arrival_sample": "S",
    "trace_S_arrival_sample": "S",
}


def _onset_arrays(metadata, target_rate=None) -> Tuple[np.ndarray, np.ndarray]:
    """(p, s) float arrays with NaN for absent picks, merging column aliases.

    With `target_rate`, arrival samples stored at another
    trace_sampling_rate_hz are rescaled to the target rate, as
    `WaveformDataset.get_sample` rescales the waveforms."""
    n = len(metadata)
    p = np.full(n, np.nan, dtype=np.float32)
    s = np.full(n, np.nan, dtype=np.float32)
    for col, phase in PHASE_COLUMNS.items():
        if col in metadata.columns:
            vals = np.asarray(metadata[col], dtype=np.float32)
            tgt = p if phase == "P" else s
            take = np.isnan(tgt) & ~np.isnan(vals)
            tgt[take] = vals[take]
    if target_rate is not None and "trace_sampling_rate_hz" in metadata.columns:
        sr = np.asarray(metadata["trace_sampling_rate_hz"], dtype=np.float32)
        scale = np.where(np.isnan(sr) | (sr <= 0), 1.0, float(target_rate) / sr)
        p *= scale
        s *= scale
    return p, s


def select_window_offsets_host(
    rng: np.random.Generator,
    lens: np.ndarray,
    p: np.ndarray,
    s: np.ndarray,
    cfg: AugmentConfig,
) -> np.ndarray:
    """Per-trace training-window start offsets, drawn on the host from
    (len, p, s, rng) alone, with the device window block's distribution.
    Draw order is fixed ([pick_s?], null-onset, gate, u)."""
    b = lens.shape[0]
    has_p, has_s = ~np.isnan(p), ~np.isnan(s)
    if cfg.selection == "first":
        base = np.where(has_p, np.nan_to_num(p, nan=np.inf), np.inf)
        base = np.minimum(base, np.where(has_s, np.nan_to_num(s, nan=np.inf), np.inf))
        onset = np.where(np.isfinite(base), base, 0.0)
    else:  # random among present picks
        pick_s = rng.random(b) < 0.5
        both = has_p & has_s
        use_s = (both & pick_s) | (has_s & ~has_p)
        onset = np.where(use_s, np.nan_to_num(s), np.nan_to_num(p))
    onset = np.where(has_p | has_s, onset, rng.random(b) * lens.astype(np.float32))

    was_start = onset.astype(np.int32) - cfg.samples_before
    gate = rng.random(b) < cfg.window_around_prob
    u = rng.random(b)
    span_was = max(cfg.pre_window - cfg.window, 0)
    off_was = was_start + np.floor(u * (span_was + 1)).astype(np.int32)
    lo = cfg.low if cfg.low is not None else 0
    hi = lens.astype(np.int32) if cfg.high is None else np.minimum(lens.astype(np.int32), cfg.high)
    span_null = np.maximum(hi - lo - cfg.window, 0)
    off_null = lo + np.floor(u * (span_null + 1).astype(np.float32)).astype(np.int32)
    return np.where(gate, off_was, off_null).astype(np.int64)


def host_window_crop(rng: np.random.Generator, batch: Dict[str, np.ndarray], cfg: AugmentConfig) -> Dict[str, np.ndarray]:
    """Select each trace's training window on the host and crop to
    (B, C, window): only the window crosses to the device, whose program then
    runs with ``cfg.pre_windowed=True``."""
    x, lens, p, s = batch["x"], batch["len"], batch["p"], batch["s"]
    off = select_window_offsets_host(rng, lens, p, s, cfg)
    b = lens.shape[0]
    w = cfg.window
    idx = off[:, None] + np.arange(w)[None, :]  # (B, w)
    valid = (idx >= 0) & (idx < lens[:, None]) & (idx < x.shape[-1])
    idx_c = np.clip(idx, 0, x.shape[-1] - 1)
    out = np.take_along_axis(x, np.broadcast_to(idx_c[:, None, :], (b, x.shape[1], w)), axis=-1)
    out = np.where(valid[:, None, :], out, 0.0).astype(np.float32)

    res = dict(batch)
    res["x"] = out
    res["len"] = np.full(b, w, dtype=np.int32)
    res["p"] = (p - off).astype(np.float32)  # NaN stays NaN for absent picks
    res["s"] = (s - off).astype(np.float32)
    return res


def device_gather_crop(pool: torch.Tensor, idx: torch.Tensor, off: torch.Tensor, lens: torch.Tensor,
                       window: int) -> torch.Tensor:
    """(B, C, window) training windows out of a trace pool on the device:
    rows `idx`, starting at `off`, zero outside [0, len): the device half of
    ``host_window_crop``, the same values. Gathers only the window's samples."""
    length = pool.shape[-1]
    pos = off[:, None].long() + torch.arange(window, device=pool.device)[None, :]  # (B, w)
    valid = (pos >= 0) & (pos < lens[:, None]) & (pos < length)
    chan = torch.arange(pool.shape[1], device=pool.device)
    out = pool[idx.long()[:, None, None], chan[None, :, None], pos.clamp(0, length - 1)[:, None, :]]
    return torch.where(valid[:, None, :], out, torch.zeros((), dtype=pool.dtype, device=pool.device))


class RawBatchSource:
    """Raw padded trace buffers + onset arrays for random batch draws.

    Small datasets are preloaded into one numpy buffer (the reference's
    cache="full"); datasets above `preload_limit_bytes` stay on disk and
    batches are read from the bucketed HDF5 on demand."""

    def __init__(
        self,
        dataset,
        buffer_len: Optional[int] = None,
        pad_multiple: int = 512,
        preload: Optional[bool] = None,
        preload_limit_bytes: int = 4 << 30,
    ):
        self.dataset = dataset
        n = len(dataset)
        self.p, self.s = _onset_arrays(dataset.metadata, target_rate=dataset.sampling_rate)
        # per-trace LP flag of the event-type detection heads
        # (EventTypeDetectionLabeller semantics, reference `models.py:1376-1456`)
        st = dataset.metadata.get("source_type")
        if st is not None:
            lp = st.astype(str).str.lower().isin({"lp", "long period", "long-period"})
            self.is_lp = lp.to_numpy().astype(np.float32)
        else:
            self.is_lp = np.zeros(n, dtype=np.float32)

        # probe a few traces for shape bookkeeping
        probe = [dataset.get_sample(i)[0] for i in range(min(n, 8))]
        c = probe[0].shape[0] if probe else 3
        self.n_channels = c
        probe_max = max((w.shape[-1] for w in probe), default=pad_multiple)

        est_bytes = n * c * probe_max * 4
        if preload is None:
            preload = est_bytes <= preload_limit_bytes
        self.preloaded = preload

        if preload:
            waves = probe + [dataset.get_sample(i)[0] for i in range(len(probe), n)]
            self.lens = np.array([w.shape[-1] for w in waves], dtype=np.int32)
            max_len = int(self.lens.max()) if n else pad_multiple
            if buffer_len is None:
                buffer_len = int(math.ceil(max_len / pad_multiple) * pad_multiple)
            self.buffer_len = buffer_len
            self.data = np.zeros((n, c, buffer_len), dtype=np.float32)
            for i, w in enumerate(waves):
                self.data[i, :, : min(w.shape[-1], buffer_len)] = w[:, :buffer_len]
            self.lens = np.minimum(self.lens, buffer_len)
        else:
            self.data = None
            if buffer_len is None:
                # from the metadata, not the 8-trace probe: a longer trace later
                # in the table would otherwise be truncated silently
                meta_max = self._max_len_from_metadata(dataset)
                buffer_len = int(
                    math.ceil(max(probe_max, meta_max, 1) / pad_multiple) * pad_multiple
                )
            self.buffer_len = buffer_len
            self.lens = None  # filled per batch
        self._n = n
        self._pools: Dict[str, torch.Tensor] = {}  # device → resident copy of self.data

    @classmethod
    def from_arrays(
        cls,
        data: np.ndarray,
        p: np.ndarray,
        s: np.ndarray,
        lens: Optional[np.ndarray] = None,
        is_lp: Optional[np.ndarray] = None,
    ) -> "RawBatchSource":
        """A preloaded source over traces in memory: data (N, C, L) float32,
        onsets p, s (N,) in samples with NaN for absent picks, `lens` the
        valid samples of each row (default L)."""
        src = object.__new__(cls)
        n = data.shape[0]
        src.dataset = None
        src.data = np.ascontiguousarray(data, dtype=np.float32)
        src.n_channels = data.shape[1]
        src.buffer_len = data.shape[-1]
        src.lens = (np.full(n, data.shape[-1], np.int32) if lens is None
                    else np.minimum(np.asarray(lens, np.int32), data.shape[-1]))
        src.p = np.asarray(p, np.float32)
        src.s = np.asarray(s, np.float32)
        src.is_lp = np.zeros(n, np.float32) if is_lp is None else np.asarray(is_lp, np.float32)
        src.preloaded = True
        src._n = n
        src._pools = {}
        return src

    @staticmethod
    def _max_len_from_metadata(dataset) -> int:
        """Upper bound on trace length at the dataset sampling rate, from
        `trace_npts`, else from the `:W` slice of bucket references
        ("bucket0$3,:3,:6000"), rescaled to the target rate."""
        import pandas as pd

        md = dataset.metadata
        n = len(md)
        lens = np.zeros(n, dtype=np.float64)
        if "trace_npts" in md.columns:
            vals = np.asarray(pd.to_numeric(md["trace_npts"], errors="coerce"))
            lens = np.where(np.isnan(vals), 0.0, vals)
        else:
            names = md.get("trace_name")
            if names is not None:
                spec = names.astype(str).str.extract(r",:(\d+)$")[0]
                vals = np.asarray(pd.to_numeric(spec, errors="coerce"))
                lens = np.where(np.isnan(vals), 0.0, vals)
        target = getattr(dataset, "sampling_rate", None)
        if target and "trace_sampling_rate_hz" in md.columns:
            sr = np.asarray(pd.to_numeric(md["trace_sampling_rate_hz"], errors="coerce"))
            scale = np.where(np.isnan(sr) | (sr <= 0), 1.0, float(target) / sr)
            lens = lens * scale
        return int(math.ceil(lens.max())) if n else 0

    def __len__(self):
        return self._n

    @staticmethod
    def _mask_onsets_beyond(onsets: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """NaN for onsets past the buffered data (a truncated trace must not
        paint labels over zeros)."""
        return np.where(onsets >= lens.astype(np.float32), np.nan, onsets)

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self.preloaded:
            lens = self.lens[idx]
            return {
                "x": self.data[idx],
                "len": lens,
                "p": self._mask_onsets_beyond(self.p[idx], lens),
                "s": self._mask_onsets_beyond(self.s[idx], lens),
                "is_lp": self.is_lp[idx],
            }
        b = len(idx)
        x = np.zeros((b, self.n_channels, self.buffer_len), dtype=np.float32)
        lens = np.zeros(b, dtype=np.int32)
        for j, i in enumerate(idx):
            w = self.dataset.get_sample(int(i))[0]
            m = min(w.shape[-1], self.buffer_len)
            x[j, :, :m] = w[:, :m]
            lens[j] = m
        return {
            "x": x,
            "len": lens,
            "p": self._mask_onsets_beyond(self.p[idx], lens),
            "s": self._mask_onsets_beyond(self.s[idx], lens),
            "is_lp": self.is_lp[idx],
        }

    def random_batch(self, rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, len(self), size=batch_size)
        return self.take(idx)

    @property
    def pool_bytes(self) -> int:
        """Bytes a device-resident copy of the trace pool would occupy."""
        return int(self.data.nbytes) if self.preloaded else 0

    def device_pool(self, device) -> torch.Tensor:
        """The whole trace pool as one tensor on `device`, uploaded once."""
        if not self.preloaded:
            raise ValueError("device_pool requires a preloaded source")
        key = str(torch.device(device))
        if key not in self._pools:
            self._pools[key] = torch.as_tensor(self.data).to(device)
        return self._pools[key]

    def take_meta(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Host metadata of rows `idx` (no waveform copy): what the offset draw
        needs plus the label onsets, masked as ``take`` masks them."""
        if not self.preloaded:
            raise ValueError("take_meta requires a preloaded source")
        lens = self.lens[idx]
        return {
            "idx": np.asarray(idx, dtype=np.int32),
            "len": lens,
            "p": self._mask_onsets_beyond(self.p[idx], lens),
            "s": self._mask_onsets_beyond(self.s[idx], lens),
            "is_lp": self.is_lp[idx],
        }


def _to_device(batch: Optional[Dict], device) -> Optional[Dict[str, torch.Tensor]]:
    if batch is None:
        return None
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).to(device)
            for k, v in batch.items()}


class TrainGenerator:
    """Epoch iterator: shuffled primary batches + random secondary/noise draws,
    augmented on `device` (the card unless ``device="cpu"``). Yields
    {"X", "y"[, "detections"], "is_lp"} tensors on that device.

    `dataset`, `eq_dataset` and `noise_dataset` are datasets or
    ``RawBatchSource``s. The augmentation's draws come from a
    ``torch.Generator`` on the device seeded `seed`."""

    def __init__(
        self,
        dataset,
        cfg: AugmentConfig,
        batch_size: int,
        eq_dataset=None,
        noise_dataset=None,
        seed: int = 42,
        drop_last: bool = True,
        prefetch: int = 2,
        host_window: bool = True,
        device_data: Optional[bool] = None,
        device_pool_budget: int = 4 << 30,
        device=None,
    ):
        self.device = resolve_device(device, "TrainGenerator")
        self.cfg = cfg
        # host-side window crop: only (B, C, window) crosses to the device; the
        # device program's window block is then an identity gather
        self.host_window = host_window
        self.batch_size = batch_size

        def source(ds):
            return ds if isinstance(ds, RawBatchSource) else RawBatchSource(ds)

        self.primary = source(dataset)
        self.eq = source(eq_dataset) if (cfg.stack and eq_dataset is not None and len(eq_dataset)) else None
        self.noise = (
            source(noise_dataset)
            if (cfg.stack and noise_dataset is not None and len(noise_dataset))
            else None
        )
        # device-resident mode: the trace pools live on the device and windows
        # are cropped there (device_gather_crop); on when every active source is
        # preloaded and the pools fit the budget, unless set
        self._device_auto = device_data is None
        self._device_pool_budget = device_pool_budget
        if device_data is None:
            srcs = [s for s in (self.primary, self.eq, self.noise) if s is not None]
            device_data = (
                host_window
                and all(s.preloaded for s in srcs)
                and 0 < sum(s.pool_bytes for s in srcs) <= device_pool_budget
            )
        self.device_data = bool(device_data)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # a dataset smaller than one batch would otherwise give no step an
        # epoch: pad one batch instead
        if drop_last and len(self.primary) < batch_size:
            drop_last = False
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.primary)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _device_on(self) -> bool:
        """The device-crop mode for this epoch: sources may be swapped after
        construction, so auto mode re-checks them (and falls back to the host
        crop); an explicit ``device_data=True`` with a lazy source raises."""
        srcs = [s for s in (self.primary, self.eq, self.noise) if s is not None]
        if self._device_auto:
            return (
                self.device_data
                and all(s.preloaded for s in srcs)
                and sum(s.pool_bytes for s in srcs) <= self._device_pool_budget
            )
        if self.device_data and not all(s.preloaded for s in srcs):
            raise RuntimeError(
                "device_data=True requires every active source preloaded; "
                "a lazy source was provided or swapped in after construction"
            )
        return self.device_data

    def _pad_idx(self, idx):
        if len(idx) < self.batch_size:  # final partial batch (drop_last=False)
            reps = math.ceil(self.batch_size / len(idx))
            idx = np.concatenate([idx] * reps)[: self.batch_size]
        return idx

    def raw_batches(self, order: np.ndarray, i: int, device_on: bool):
        """Step i's five cropped raw batches (prim, sec, sec2, noi, noi2; the
        last four None without stacking) on the device, drawing from
        ``self.rng`` in the JAX generator's order: batch indices of every
        source, then window offsets prim/sec/sec2/noi/noi2."""
        stack_on = self.cfg.stack and self.eq is not None
        sec_cfg = self.cfg.for_secondary()
        noise_src = self.noise or self.eq
        dev = self.device
        if device_on:
            def crop(src: RawBatchSource, meta: Dict, cfgx: AugmentConfig) -> Dict:
                off = select_window_offsets_host(self.rng, meta["len"], meta["p"], meta["s"], cfgx)
                x = device_gather_crop(
                    src.device_pool(dev),
                    torch.as_tensor(meta["idx"]).to(dev),
                    torch.as_tensor(off.astype(np.int32)).to(dev),
                    torch.as_tensor(meta["len"].astype(np.int32)).to(dev),
                    cfgx.window,
                )
                return _to_device({
                    "x": x,
                    "len": np.full(len(off), cfgx.window, dtype=np.int32),
                    "p": (meta["p"] - off).astype(np.float32),
                    "s": (meta["s"] - off).astype(np.float32),
                    "is_lp": meta["is_lp"],
                }, dev)

            prim_meta = self.primary.take_meta(self._pad_idx(order[i * self.batch_size : (i + 1) * self.batch_size]))
            if stack_on:
                metas = [src.take_meta(self.rng.integers(0, len(src), size=self.batch_size))
                         for src in (self.eq, self.eq, noise_src, noise_src)]
            prim = crop(self.primary, prim_meta, self.cfg)
            if not stack_on:
                return prim, None, None, None, None
            return (prim,) + tuple(crop(src, m, c) for src, m, c in zip(
                (self.eq, self.eq, noise_src, noise_src), metas, (sec_cfg, sec_cfg, self.cfg, self.cfg)))

        idx = order[i * self.batch_size : (i + 1) * self.batch_size]
        prim = self.primary.take(idx)
        if len(idx) < self.batch_size:  # final partial batch (drop_last=False)
            reps = math.ceil(self.batch_size / len(idx))
            prim = {k: np.concatenate([v] * reps)[: self.batch_size] for k, v in prim.items()}
        if stack_on:
            sec = self.eq.random_batch(self.rng, self.batch_size)
            sec2 = self.eq.random_batch(self.rng, self.batch_size)
            noi = noise_src.random_batch(self.rng, self.batch_size)
            noi2 = noise_src.random_batch(self.rng, self.batch_size)
        else:
            sec = sec2 = noi = noi2 = None
        if self.host_window:
            prim = host_window_crop(self.rng, prim, self.cfg)
            if stack_on:
                sec = host_window_crop(self.rng, sec, sec_cfg)
                sec2 = host_window_crop(self.rng, sec2, sec_cfg)
                noi = host_window_crop(self.rng, noi, self.cfg)
                noi2 = host_window_crop(self.rng, noi2, self.cfg)
        return tuple(_to_device(r, dev) for r in (prim, sec, sec2, noi, noi2))

    def epoch(self) -> Iterator[Dict[str, torch.Tensor]]:
        n = len(self.primary)
        order = self.rng.permutation(n)
        steps = len(self)
        device_on = self._device_on()
        dev_cfg = (
            dataclasses.replace(self.cfg, pre_windowed=True)
            if (self.host_window or device_on)
            else self.cfg
        )

        def make(i):
            raw = self.raw_batches(order, i, device_on)
            draws = draw_augment(self.gen, self.batch_size, raw[0]["x"].shape[1], dev_cfg, self.device,
                                 stack=raw[1] is not None)
            return augment_train_batch(*raw, dev_cfg, draws)

        # software pipeline: a producer thread assembles host batches (HDF5
        # reads in lazy mode) and queues the device work ahead of the consumer
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        err = []
        stop = threading.Event()

        def producer():
            try:
                for i in range(steps):
                    if stop.is_set():
                        break
                    q.put(make(i))
            except Exception as e:  # surface worker failures to the consumer
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            # the consumer may leave the epoch early: stop the producer and
            # drain its queue so it never blocks at interpreter teardown
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
        if err:
            raise err[0]


def steered_frames(x: torch.Tensor, w0: torch.Tensor, window: int, detrend: bool = False,
                   norm: str = "peak") -> torch.Tensor:
    """Steered framing and conditioning on the device.

    x: (B, C, L) raw zero-padded trace buffers; w0: (B,) window starts, as
    ``steered_window_offsets`` gives them. Returns the conditioned (B, C,
    window) frames: each row's `window` samples from w0 (zero outside the
    buffer) in one gather, demeaned (or detrended), then normalised per
    channel. The JAX module pads the buffer by `window` on both sides and
    slices it, which clamps a start to [-window, L]; so does this."""
    b, c, length = x.shape
    start = w0.to(device=x.device, dtype=torch.long).clamp(-window, length)
    pos = start[:, None] + torch.arange(window, device=x.device)[None, :]  # (B, window)
    valid = (pos >= 0) & (pos < length)
    frames = torch.gather(x, 2, pos.clamp(0, length - 1)[:, None, :].expand(b, c, window))
    frames = torch.where(valid[:, None, :], frames, torch.zeros((), dtype=x.dtype, device=x.device))
    frames = detrend_linear(frames) if detrend else demean(frames)
    return normalize_amplitude(frames, norm=norm, per_channel=True)


def steered_window_offsets(
    lens: np.ndarray, start_samples: np.ndarray, end_samples: np.ndarray, window: int
) -> Tuple[np.ndarray, np.ndarray]:
    """SteeredWindow placement over a batch of traces of their own lengths:
    centre the [start, end) region, clip the window into the trace, zero-pad
    a trace shorter than the window. Returns (w0 (B,), borders (B, 2)), the
    region's span inside each window."""
    ss = np.asarray(start_samples, dtype=np.int64)
    es = np.asarray(end_samples, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    region = es - ss
    w0 = ss - (window - region) // 2
    w0 = np.clip(w0, 0, np.maximum(lens - window, 0))
    border_lo = ss - w0
    return w0, np.stack([border_lo, border_lo + region], axis=1)


def eval_batch(
    dataset,
    indices: Sequence[int],
    window: int,
    start_samples: Sequence[int],
    end_samples: Sequence[int],
    norm: str = "peak",
    detrend: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Steered evaluation batch on the host, trace by trace (the reference's
    SteeredWindow + Normalize eval augmentations, `models.py:445-452`):
    (X (B, C, window) conditioned float32, window_borders (B, 2))."""
    from volpick_tpu_torch.ops.windows import pad_frame, steered_window_indices

    xs, borders = [], []
    for idx, ss, es in zip(indices, start_samples, end_samples):
        data, _ = dataset.get_sample(int(idx))
        w0, lo, hi = steered_window_indices(data.shape[-1], np.array([ss]), np.array([es]), window)
        xs.append(pad_frame(data, int(w0[0]), window))
        borders.append((int(lo[0]), int(hi[0])))
    x = np.stack(xs).astype(np.float32)
    if detrend:
        t = np.arange(window) - (window - 1) / 2
        slope = ((x - x.mean(-1, keepdims=True)) * t).sum(-1, keepdims=True) / (t * t).sum()
        x = x - x.mean(-1, keepdims=True) - slope * t
    else:
        x = x - x.mean(-1, keepdims=True)
    if norm == "peak":
        x = x / (np.abs(x).max(-1, keepdims=True) + 1e-10)
    else:
        x = x / (x.std(-1, keepdims=True) + 1e-10)
    return x, np.asarray(borders, dtype=np.int64)
