"""annotate() / classify(): continuous-stream picking in PyTorch.

Port of ``volpick_tpu/picker/annotate.py`` (the SeisBench WaveformModel
surface the reference documents):

    picker = WaveformPicker(load_model("eqtransformer"))  # on the card; device="cpu" for the CPU
    output = picker.classify(stream, overlap=5500, blinding=(500, 500), batch_size=256)

The model is any of the registry's: EQTransformer, VolEQTransformer (two
detection heads), PhaseNet and TPUPickNet (P/S/N softmax curves).

Per station batch (S, C, W_total) on the device:
1. frame the stream into windows at stride = window - overlap, plus one
   window flush with the stream end when the grid does not end there;
2. condition each window (demean or linear detrend, per-channel peak/std);
3. run the model;
4. stack the overlapping window predictions with edge blinding ("avg"/"max");
5. extract two-threshold triggers on every non-noise channel in one call.
Only the fixed-size pick buffers come back to the host.

Stream grouping and the result types are the port's own host layer,
``volpick_tpu_torch.core``; the picker reads a stream's attributes only, so
any stream object with the same surface is accepted. With
``use_pallas=True`` step 2 runs the conditioning kernel of
``ops/cuda/conditioning.py`` on framed windows. Everything runs in float32; on CUDA, TF32 is switched
off for cuDNN convolutions and matmuls while the picker works (and restored
after), so results stay comparable with the CPU and the JAX reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from volpick_tpu_torch.core.picks import ClassifyOutput, Detection, Pick, PickList
from volpick_tpu_torch.core.stream import Stream, Trace, UTC, group_streams_by_instrument
from volpick_tpu_torch.device import inference_work, resolve_device
from volpick_tpu_torch.ops.cuda.conditioning import condition_windows
from volpick_tpu_torch.ops.signal import (
    condition_windows_from_span,
    demean,
    detrend_linear,
    normalize_amplitude,
)
from volpick_tpu_torch.ops.triggers import extract_triggers_batched
from volpick_tpu_torch.ops.windows import (
    frame_windows,
    frame_windows_uniform,
    overlap_stack,
    overlap_stack_uniform,
    uniform_stack_weights,
    window_starts,
)

__all__ = ["WaveformPicker", "Stream", "Trace", "UTC"]


class WaveformPicker:
    """Batched continuous picking with a model on one device.

    ``device`` is a CUDA device or "cpu"; ``None`` (the default) is "cuda".
    CUDA that is not available raises instead of running on the CPU: pass
    ``device="cpu"`` to ask for the CPU. The model is moved to the device
    and put in eval mode. ``use_pallas=True`` (the JAX picker's
    name for the switch) conditions framed windows with the kernel of
    ``ops/cuda/conditioning.py`` instead of conditioning each step's span.
    ``span_conditioning`` (the JAX picker's switch too) lets a step condition
    its windows from its span of the stream when the stride divides the
    window; ``False`` conditions the framed windows one by one. ``None`` reads
    ``$VOLPICK_SPAN_COND`` (``"0"`` is off, any other value on, unset on),
    once, here."""

    def __init__(
        self,
        model,
        device=None,
        detrend: Optional[bool] = None,
        use_pallas: bool = False,
        span_conditioning: Optional[bool] = None,
    ):
        device = resolve_device(device, "WaveformPicker")
        self.device = device
        self.model = model.to(device).eval()
        # EQT conditions windows by detrend, PhaseNet by demean (reference
        # `volpick/model/models.py:263,664`). The rule is the JAX picker's,
        # name for name: VolEQTransformer windows are demeaned.
        self.detrend = detrend if detrend is not None else model.name == "EQTransformer"
        self.use_pallas = use_pallas
        # frozen at construction like the other switches, so a later change of
        # the environment does not move a running picker to the other branch
        if span_conditioning is None:
            env = os.environ.get("VOLPICK_SPAN_COND", "").strip()
            span_conditioning = env != "0" if env else True
        self.span_conditioning = bool(span_conditioning)
        # freeze an env-selected model route (TPUPickNet's attn, the EQT
        # family's fused) now, so a later change of the environment does not
        # switch it mid-run
        if hasattr(model, "resolve_attn"):
            model.attn = model.resolve_attn()
        if hasattr(model, "resolve_fused"):
            model.fused = model.resolve_fused()

    @property
    def in_samples(self) -> int:
        return self.model.in_samples

    @property
    def phases(self) -> List[str]:
        return [p for p in self.model.phases]

    def _prob_channels(self) -> List[str]:
        """Output channel names in prediction order."""
        if self.model.name == "VolEQTransformer":
            return ["Detection_rg", "Detection_lp", "P", "S"]
        if self.model.name == "EQTransformer":
            return ["Detection", "P", "S"]
        return list(self.model.phases)

    def _default_batch_size(self) -> int:
        return int(getattr(self.model, "default_classify_batch", 256))

    # ------------------------------------------------------------ device path
    def _apply_model(self, frames: torch.Tensor) -> torch.Tensor:
        """Conditioned (N, C, window) windows → (N, K, window) float32 probabilities."""
        out = self.model(frames)
        if isinstance(out, tuple):  # EQT family: per-head (N, window) outputs
            out = torch.stack(out, dim=1)
        return out.float()

    def _condition(self, frames: torch.Tensor) -> torch.Tensor:
        """Condition (..., C, window) windows per channel."""
        if self.use_pallas:
            flat = frames.reshape((-1,) + frames.shape[-2:]).contiguous()
            return condition_windows(
                flat, detrend=self.detrend, norm=self.model.norm
            ).reshape(frames.shape)
        frames = detrend_linear(frames) if self.detrend else demean(frames)
        return normalize_amplitude(frames, norm=self.model.norm, per_channel=True)

    def _curves(
        self,
        data: torch.Tensor,
        starts: np.ndarray,
        total: int,
        blinding: Tuple[int, int],
        stacking: str,
        chunk: int,
        stride: int,
        flush_start: Optional[int],
    ) -> torch.Tensor:
        """Frame → condition → forward → overlap stack: data (S, C, total) →
        (S, K, total) curves, shared by classify and annotate.

        Uniform grid (starts i*stride, plus the optional flush window): the
        windows go through the model in ceil(n_uni / wpc) steps of wpc window
        indices x S stations; each step conditions its windows straight from
        its contiguous span of the stream and adds its locally stacked sums
        into one accumulator, divided at the end by static host-side weights.
        wpc is balanced (ceil(n_uni / n_steps)) so the last step carries few
        padded windows, which are zeroed. Strides with ceil(window/stride) > 64
        take a gather + scatter path instead."""
        window = self.in_samples
        n_win = len(starts)
        n_uni = n_win - (1 if flush_start is not None else 0)
        l, r = blinding
        s, c = data.shape[0], data.shape[1]

        if -(-window // stride) > 64:
            # non-uniform fallback: gather framing + scatter stacking
            starts_t = torch.as_tensor(starts, device=data.device)
            frames = frame_windows(data, starts_t, window).movedim(0, 1)
            frames = frames.reshape(s * n_win, c, window)
            preds = torch.cat([
                self._apply_model(self._condition(frames[j : j + chunk]))
                for j in range(0, s * n_win, chunk)
            ])
            preds = preds.reshape(s, n_win, preds.shape[1], window)
            return overlap_stack(preds, starts_t, total, blinding=blinding, stacking=stacking)

        k_ch = len(self._prob_channels())
        m = max(-(-window // stride), 1)
        wpc = max(1, chunk // s)  # window indices per step
        n_steps = -(-n_uni // wpc)
        wpc = max(1, -(-n_uni // n_steps))  # balanced steps
        span = (wpc - 1) * stride + window
        need = (n_steps - 1) * wpc * stride + span
        datap = torch.nn.functional.pad(data, (0, need - total)) if need > total else data
        local_len = (wpc + m - 1) * stride
        acc_len = max((n_steps * wpc + m - 1) * stride, total)
        # per-window mean/slope from stride-block sums of the raw span, when
        # the stride divides the window (EQT 6000/500) and span conditioning
        # is on; not under use_pallas, which conditions the framed windows in
        # the kernel
        span_cond = self.span_conditioning and window % stride == 0 and not self.use_pallas

        acc = torch.zeros((s, k_ch, acc_len), dtype=torch.float32, device=data.device)
        for i in range(n_steps):
            off = i * wpc * stride
            sp = datap[..., off : off + span]  # (S, C, span)
            if span_cond:
                fr = condition_windows_from_span(
                    sp, wpc, stride, window, detrend=self.detrend, norm=self.model.norm
                )
            else:
                fr = self._condition(frame_windows_uniform(sp, wpc, stride, window))
            pr = self._apply_model(fr.reshape(wpc * s, c, window)).reshape(wpc, s, k_ch, window)
            # zero the padded window indices of the last step (their static
            # stacking weight is zero too)
            wmask = (i * wpc + torch.arange(wpc, device=data.device)) < n_uni
            pr = pr * wmask.to(pr.dtype)[:, None, None, None]
            loc, _ = overlap_stack_uniform(
                pr.movedim(1, 0), stride, blinding=blinding, stacking=stacking, return_sums=True
            )  # (S, K, local_len)
            cur = acc[..., off : off + local_len]
            if stacking == "avg":
                cur += loc
            else:
                cur.copy_(torch.maximum(cur, loc))

        wgt = uniform_stack_weights(n_uni, stride, window, blinding, acc_len)
        if flush_start is not None:
            # the flush window ends at the stream end: a static-offset add
            fl = data[..., flush_start : flush_start + window]
            fmask = np.zeros((window,), dtype=np.float32)
            fmask[l : window - r if r else window] = 1.0
            flc = self._apply_model(self._condition(fl)) * torch.as_tensor(fmask, device=data.device)
            cur = acc[..., flush_start : flush_start + window]
            if stacking == "avg":
                cur += flc
                wgt = wgt.copy()
                wgt[flush_start : flush_start + window] += fmask
            else:
                cur.copy_(torch.maximum(cur, flc))
        acc = acc[..., :total]
        if stacking == "avg":
            return acc / torch.as_tensor(np.maximum(wgt[:total], 1.0), device=data.device)
        return acc

    # ------------------------------------------------------------- array level
    def _plan_windows(self, data: np.ndarray, overlap: int):
        """SeisBench window placement shared by classify and annotate: a
        uniform grid at i*stride plus, when it does not end at the last
        sample, one window flush with the stream end. Streams shorter than
        one window are zero-padded to one window. Returns
        (data, padded_total, starts, flush_start)."""
        window = self.in_samples
        stride = window - overlap
        total = data.shape[-1]
        if total <= window:
            if window > total:
                data = np.pad(data, ((0, 0), (0, 0), (0, window - total)))
            return data, window, np.array([0], dtype=np.int64), None
        starts = window_starts(total, window, overlap)
        flush_start = (
            int(starts[-1])
            if len(starts) >= 2 and int(starts[-1]) != (len(starts) - 1) * stride
            else None
        )
        return data, total, starts, flush_start

    def _to_device(self, data: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data, dtype=np.float32), device=self.device)

    def classify_arrays(
        self,
        data: np.ndarray,
        thresholds: Dict[str, float],
        overlap: Optional[int] = None,
        blinding: Tuple[int, int] = (0, 0),
        stacking: str = "avg",
        batch_size: Optional[int] = None,
        max_picks: Optional[int] = None,
        max_span: int = 500_000,
    ) -> Dict[str, tuple]:
        """Classify a station batch (S, C, W_total) at the model's sampling rate.

        Returns {label: (peak_idx, peak_val, valid, on_idx, off_idx)} numpy
        arrays, each (S, n_picks). Streams longer than `max_span` samples are
        processed as overlapping stride-aligned segments with a full window
        of context on each side; a pick belongs to the segment whose core
        holds its peak, so the result matches one pass over the whole stream."""
        s, c, total = data.shape
        if batch_size is None:
            batch_size = self._default_batch_size()
        window = self.in_samples
        if overlap is None:
            overlap = window // 2
        stride = window - overlap
        if total > max_span:
            ctx = (-(-window // stride)) * stride  # window rounded up to the grid
            core = max(((max_span - 2 * ctx) // stride) * stride, stride)
            merged: Dict[str, list] = {}
            seg_start = 0
            while seg_start < total:
                own_lo = seg_start
                own_hi = min(seg_start + core, total)
                g_lo = max(seg_start - ctx, 0)
                g_hi = min(own_hi + ctx, total)
                res = self.classify_arrays(
                    data[..., g_lo:g_hi], thresholds, overlap=overlap, blinding=blinding,
                    stacking=stacking, batch_size=batch_size, max_picks=max_picks,
                    max_span=2**62,
                )
                for label, (pk, val, valid, on, off) in res.items():
                    own = valid & (pk + g_lo >= own_lo) & (pk + g_lo < own_hi)
                    merged.setdefault(label, []).append(
                        (pk + g_lo, val, own, on + g_lo, off + g_lo)
                    )
                seg_start = own_hi
            return {
                label: tuple(np.concatenate([seg[i] for seg in segs], axis=1) for i in range(5))
                for label, segs in merged.items()
            }
        data, padded_total, starts, flush_start = self._plan_windows(data, overlap)
        if max_picks is None:
            max_picks = min(max(32, padded_total // window * 4), 4096)
        channels = self._prob_channels()
        # the noise row never triggers; any other missing label is a caller
        # mistake and fails loudly
        thr = [thresholds.get(lab, 2.0) if lab == "N" else thresholds[lab] for lab in channels]
        with inference_work(self.device):
            curves = self._curves(
                self._to_device(data), starts, padded_total, tuple(blinding), stacking,
                batch_size, stride, flush_start,
            )
            trig = [(label, ki, t) for ki, (label, t) in enumerate(zip(channels, thr)) if label != "N"]
            flat = torch.cat([curves[:, ki] for _, ki, _ in trig], dim=0)
            thr_rows = torch.cat([
                torch.full((s,), t, dtype=torch.float32, device=self.device) for _, _, t in trig
            ])
            res = [a.cpu().numpy() for a in extract_triggers_batched(flat, thr_rows, max_picks=max_picks)]
        return {
            label: tuple(a[j * s : (j + 1) * s] for a in res) for j, (label, _, _) in enumerate(trig)
        }

    def annotate_array(
        self,
        data: np.ndarray,
        overlap: Optional[int] = None,
        blinding: Tuple[int, int] = (0, 0),
        stacking: str = "avg",
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Continuous probability curves (S, K, W_total) for a station batch
        (S, C, W_total); the same window set and stacking as classify_arrays."""
        total = data.shape[-1]
        if batch_size is None:
            batch_size = self._default_batch_size()
        window = self.in_samples
        if overlap is None:
            overlap = window // 2
        data, padded_total, starts, flush_start = self._plan_windows(data, overlap)
        with inference_work(self.device):
            curves = self._curves(
                self._to_device(data), starts, padded_total, tuple(blinding), stacking,
                batch_size, window - overlap, flush_start,
            )
            return curves.cpu().numpy()[..., :total]

    # ------------------------------------------------------------ stream level
    def _group_arrays(self, stream: Stream):
        """Instrument groups → (key, data (C, W), t0, sampling_rate)."""
        sr = self.model.sampling_rate
        order = self.model.component_order
        out = []
        for key, group in group_streams_by_instrument(stream).items():
            group = Stream([tr.copy() for tr in group]).merge_overlaps()
            for tr in group:
                if abs(tr.stats.sampling_rate - sr) > 1e-6:
                    tr.resample(sr)
            # align by earliest start; zero-fill missing components
            t0 = min(tr.stats.starttime.timestamp for tr in group)
            t1 = max(tr.stats.endtime.timestamp for tr in group)
            total = int(round((t1 - t0) * sr)) + 1
            data = np.zeros((len(order), total), dtype=np.float32)
            for tr in group:
                comp = tr.stats.channel[-1] if tr.stats.channel else ""
                if comp not in order:
                    continue
                ci = order.index(comp)
                off = int(round((tr.stats.starttime.timestamp - t0) * sr))
                n = min(tr.stats.npts, total - off)
                data[ci, off : off + n] = tr.data[:n]
            out.append((key, data, UTC(t0), sr))
        return out

    @staticmethod
    def _by_length(groups) -> Dict[int, List]:
        by_len: Dict[int, List] = {}
        for g in groups:
            by_len.setdefault(g[1].shape[-1], []).append(g)
        return by_len

    def annotate(
        self,
        stream: Stream,
        overlap: Optional[int] = None,
        blinding: Tuple[int, int] = (0, 0),
        stacking: str = "avg",
        batch_size: Optional[int] = None,
    ) -> Stream:
        """Probability-curve Stream: one trace per instrument and output
        channel, named "<ModelName>_<label>", at the model's sampling rate."""
        ann = Stream()
        for _, gs in self._by_length(self._group_arrays(stream)).items():
            curves = self.annotate_array(
                np.stack([g[1] for g in gs]), overlap=overlap, blinding=blinding,
                stacking=stacking, batch_size=batch_size,
            )
            for (key, _, t0, sr), cv in zip(gs, curves):
                net, sta, loc, _ = (key.split(".") + ["", "", "", ""])[:4]
                for ki, label in enumerate(self._prob_channels()):
                    ann.append(Trace(cv[ki], dict(
                        network=net, station=sta, location=loc,
                        channel=f"{self.model.name}_{label}", sampling_rate=sr, starttime=t0,
                    )))
        return ann

    def classify(
        self,
        stream: Stream,
        P_threshold: Optional[float] = None,
        S_threshold: Optional[float] = None,
        detection_threshold: Optional[float] = None,
        overlap: Optional[int] = None,
        blinding: Tuple[int, int] = (0, 0),
        stacking: str = "avg",
        batch_size: Optional[int] = None,
    ) -> ClassifyOutput:
        """Picks and detections on a continuous Stream.

        Thresholds default to the model's ``default_args`` (else 0.3). A pick
        is trigger_onset(prob, thr, thr/2) plus the in-trigger argmax
        (reference `volpick/model/eval_taks0.py:46-56`)."""
        d = self.model.default_args
        det = detection_threshold if detection_threshold is not None else d.get("detection_threshold", 0.3)
        thresholds = {
            "P": P_threshold if P_threshold is not None else d.get("P_threshold", 0.3),
            "S": S_threshold if S_threshold is not None else d.get("S_threshold", 0.3),
            "Detection": det,
            # VolEQTransformer's per-type detection heads share the threshold
            "Detection_rg": det,
            "Detection_lp": det,
            "N": 2.0,  # the noise channel never triggers
        }
        picks = PickList()
        detections: List[Detection] = []
        for total, gs in self._by_length(self._group_arrays(stream)).items():
            results = self.classify_arrays(
                np.stack([g[1] for g in gs]), thresholds, overlap=overlap, blinding=blinding,
                stacking=stacking, batch_size=batch_size,
            )
            for gi, (key, _, t0, sr) in enumerate(gs):
                trace_id = key.rsplit(".", 1)[0]  # net.sta.loc
                for label, (pk, val, valid, on, off) in results.items():
                    for j in np.where(valid[gi])[0]:
                        # a trigger in the zero-padded tail of a stream shorter
                        # than one window is not data: drop picks whose onset
                        # or peak lies past the end, clamp the trigger end
                        if on[gi, j] >= total or pk[gi, j] >= total:
                            continue
                        end = min(int(off[gi, j]), total - 1)
                        if label.startswith("Detection"):
                            detections.append(Detection(
                                trace_id=trace_id, start_time=t0 + on[gi, j] / sr,
                                end_time=t0 + end / sr, peak_value=float(val[gi, j]),
                            ))
                        else:
                            picks.append(Pick(
                                trace_id=trace_id, start_time=t0 + on[gi, j] / sr,
                                end_time=t0 + end / sr, peak_time=t0 + pk[gi, j] / sr,
                                peak_value=float(val[gi, j]), phase=label,
                            ))
        picks.sort()
        return ClassifyOutput(self.model.name, picks, detections)
