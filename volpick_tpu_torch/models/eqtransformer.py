"""EQTransformer (Mousavi et al. 2020) in PyTorch, eval and train forwards.

Port of ``volpick_tpu/models/eqtransformer.py``: encoder (7 convs + max
pools) → 7 pre-activation res-CNN blocks → 3 BiLSTM blocks → 2 transformer
blocks with dense additive attention → a detection decoder plus P/S pick
branches (an LSTM and width-3 attention each), each with its own decoder and
sigmoid head. While a ``torch.profiler`` session is active the eval forward
records the spans ``eqt.encoder``, ``eqt.res_cnn``, ``eqt.bilstm``,
``eqt.transformer`` and ``eqt.branches`` (``utils/profiling.py::span``),
timed on the device. The eval forward in float32 runs each encoder layer
through ``ops/cuda/convpool.py::convpool_relu`` (conv, bias, ReLU and
max-pool in one kernel launch on the card) on every route, and counts those
layers as ``convpool`` on the ``eqt.encoder`` span. ``fused``
selects among the JAX package's routes through that program
(``parse_fused``); the default, ``"plstm+bandattn"``, runs every LSTM
recurrence through ``ops/cuda/lstm.py::lstm_branches`` (both pick LSTMs in one
merged recurrence) and the pick attention over its band only. With ``"pattn"``
the transformer blocks' attention goes through
``ops/cuda/addattn.py::seq_self_attention``. The eval forward in float32 on
a per-branch decoder route without ``"polyup"`` (the default among them)
runs each decoder layer through ``ops/cuda/upconv.py::upconv_relu``, one
kernel launch a layer on the card, and counts those layers as ``upconv`` on
the ``eqt.branches`` span. A layer whose shape a kernel does not take (the
wrapper raises ``LayerRefused``: an even or long kernel, a tile that fits no
CTA) runs the plain code, as train mode and bf16 do.

In train mode (``model.train()``) the forward takes the per-branch program,
as the JAX ``apply(train=True)`` does: plain recurrences and the dense masked
pick attention, no kernel, every BatchNorm on the batch's statistics (the
running statistics updated in place). Dropout sits where JAX puts it
(spatial dropout after each res-CNN activation, dropout after each BiLSTM,
the transformers' feed-forward hidden layer and each pick LSTM) and draws its
masks from the ``generator`` passed to ``forward``; without one there is no
dropout, as JAX without an ``rng``.

Submodules and parameters carry the SeisBench state-dict names (the key map
of ``volpick_tpu/models/torch_import.py::import_eqtransformer``), so a
published ``volpick.pt.v1`` loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from volpick_tpu_torch.models.layers import (
    bilstm,
    conv1d,
    conv1d_same,
    dropout,
    layer_norm_keras,
    lstm,
    max_pool1d,
    seq_self_attention,
    seq_self_attention_banded,
    seq_self_attention_masked,
    spatial_dropout1d,
    upsample2_conv1d_same,
    upsample_nearest,
)
from volpick_tpu_torch.models.params import Conv, bn, norm, uniform
from volpick_tpu_torch.ops.cuda import LayerRefused
from volpick_tpu_torch.ops.cuda.addattn import seq_self_attention as seq_self_attention_kernel
from volpick_tpu_torch.ops.cuda.convpool import convpool_relu
from volpick_tpu_torch.ops.cuda.lstm import lstm_branches, lstm_branches_reference
from volpick_tpu_torch.ops.cuda.upconv import upconv_relu
from volpick_tpu_torch.utils import profiling

_BN_EPS = 1e-3
_LN_EPS = 1e-14
_ATTN_EPS = 1e-5

DEFAULT_FUSED = "plstm+bandattn"
PER_BRANCH = "0"  # the canonical name of fused=False, the per-branch program
_FUSED_TOKENS = ("lstm", "plstm", "grouped", "blockdiag", "bandattn", "polyup", "pattn")
STAGES = ("encoder", "res_cnn", "bilstm", "transformer", "pick")


def parse_fused(fused: Union[str, bool]) -> str:
    """Canonical ``fused`` route from a flag of the JAX package's grammar.

    True or "1" is the default route ``"plstm+bandattn"``; False, "0" or an
    empty flag is the per-branch program, ``"0"``; otherwise a "+"-joined set of

    - ``"lstm"``: each BiLSTM's two directions and the pick LSTMs ride merged
      recurrences, in plain PyTorch; ``"plstm"``: the same through the LSTM
      kernel (implies ``"lstm"``);
    - ``"bandattn"``: the pick attention computes its width-3 band only,
      instead of dense energies masked afterwards (an O(eps) difference);
    - ``"pattn"``: the transformer blocks' attention through its kernel;
    - ``"grouped"`` / ``"blockdiag"``: the decoders of all branches as one
      grouped convolution stack / one dense stack with block-diagonal weights;
    - ``"polyup"``: a decoder's upsample + conv as two polyphase convs at the
      input's resolution (composes with the two above).

    The result names the tokens in that fixed order without the implied ones.
    An unknown token raises ValueError."""
    flag = fused.strip().lower() if isinstance(fused, str) else fused
    if flag is True or flag in ("1", "true", "on", "yes"):
        return DEFAULT_FUSED
    if not flag or flag in ("0", "false", "off", "no"):
        return PER_BRANCH
    parts = set(str(flag).split("+"))
    unknown = parts - set(_FUSED_TOKENS)
    if unknown:
        raise ValueError(f"unknown fused flags: {sorted(unknown)}")
    picked = [
        "plstm" if "plstm" in parts else "lstm" if "lstm" in parts else "",
        "bandattn" if "bandattn" in parts else "",
        "pattn" if "pattn" in parts else "",
        "grouped" if "grouped" in parts else "blockdiag" if "blockdiag" in parts else "",
        "polyup" if "polyup" in parts else "",
    ]
    return "+".join(t for t in picked if t)


def _block_diag_kernel(ws: List[torch.Tensor]) -> torch.Tensor:
    """Per-branch conv kernels (O, I, K) stacked into one dense block-diagonal
    kernel (G·O, G·I, K): branch g's filters see only channels [g·I, (g+1)·I)."""
    o, i, k = ws[0].shape
    w = ws[0].new_zeros((len(ws) * o, len(ws) * i, k))
    for j, wj in enumerate(ws):
        w[j * o : (j + 1) * o, j * i : (j + 1) * i] = wj
    return w


def _encoder_pool_paddings(in_samples: int, n_layers: int) -> List[int]:
    """Per-layer max-pool paddings: odd-length maps pad by 1 (keras 'same' pooling)."""
    pads = []
    cur = in_samples
    for _ in range(n_layers):
        p = cur % 2
        pads.append(p)
        cur = (cur + p) // 2
    return pads


def _decoder_crops(out_samples: int, n_layers: int) -> List[int]:
    """Decoder layers (by index) that drop one trailing sample after 2x upsampling."""
    crops = []
    cur = out_samples
    for i in range(n_layers):
        p = cur % 2
        cur = (cur + p) // 2
        if p == 1:
            crops.append(n_layers - 1 - i)
    return crops


class Linear(nn.Module):
    """Linear parameters (weight (O, I), bias (O,)); uniform(±bound) init."""

    def __init__(self, i: int, o: int, bound: float, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(uniform((o, i), bound, gen))
        self.bias = nn.Parameter(torch.zeros(o))


def _unless_refused(layer, *args, **kwargs) -> Optional[torch.Tensor]:
    """``layer(*args, **kwargs)`` (K8's or K9's wrapper), or None where it
    refuses the layer's shape (``LayerRefused``): the caller then runs its
    plain code. Every other refusal propagates."""
    try:
        return layer(*args, **kwargs)
    except LayerRefused:
        return None


def _bn(c: int) -> nn.BatchNorm1d:
    return bn(c, _BN_EPS)


class LSTMWeights(nn.Module):
    """One-layer LSTM parameters under nn.LSTM's names (weight_ih_l0, ...,
    plus *_reverse when bidirectional); uniform(±sqrt(1/H)) weights, zero biases."""

    def __init__(self, inp: int, hid: int, gen: torch.Generator, bidirectional: bool = False):
        super().__init__()
        bound = (1.0 / hid) ** 0.5
        for suf in ("_l0", "_l0_reverse") if bidirectional else ("_l0",):
            self.register_parameter(f"weight_ih{suf}", nn.Parameter(uniform((4 * hid, inp), bound, gen)))
            self.register_parameter(f"weight_hh{suf}", nn.Parameter(uniform((4 * hid, hid), bound, gen)))
            self.register_parameter(f"bias_ih{suf}", nn.Parameter(torch.zeros(4 * hid)))
            self.register_parameter(f"bias_hh{suf}", nn.Parameter(torch.zeros(4 * hid)))

    def bidirectional_params(self) -> Dict[str, torch.Tensor]:
        p = {}
        for suf, key in (("_l0", ""), ("_l0_reverse", "_rev")):
            p[f"w_ih{key}"] = getattr(self, f"weight_ih{suf}")
            p[f"w_hh{key}"] = getattr(self, f"weight_hh{suf}")
            p[f"b_ih{key}"] = getattr(self, f"bias_ih{suf}")
            p[f"b_hh{key}"] = getattr(self, f"bias_hh{suf}")
        return p


class SeqSelfAttention(nn.Module):
    def __init__(self, c: int, gen: torch.Generator, units: int = 32):
        super().__init__()
        self.Wx = nn.Parameter(uniform((c, units), 0.02, gen))
        self.Wt = nn.Parameter(uniform((c, units), 0.02, gen))
        self.bh = nn.Parameter(torch.zeros(units))
        self.Wa = nn.Parameter(uniform((units, 1), 0.02, gen))
        self.ba = nn.Parameter(torch.zeros(1))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"Wx": self.Wx, "Wt": self.Wt, "bh": self.bh, "Wa": self.Wa, "ba": self.ba}


class LayerNormalization(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c, 1))
        self.beta = nn.Parameter(torch.zeros(c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_keras(x, self.gamma, self.beta, _LN_EPS)


class FeedForward(nn.Module):
    def __init__(self, c: int, gen: torch.Generator, hidden: int = 128):
        super().__init__()
        self.lin1 = Linear(c, hidden, 0.05, gen)
        self.lin2 = Linear(hidden, c, 0.05, gen)

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f = F.relu(x.transpose(1, 2) @ self.lin1.weight.T + self.lin1.bias)
        f = dropout(f, drop_rate, generator, self.training)
        return (f @ self.lin2.weight.T + self.lin2.bias).transpose(1, 2)


class Transformer(nn.Module):
    """Dense additive self-attention + residual + keras LayerNorm, then a
    16→128→16 feed-forward + residual + LayerNorm."""

    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        self.attention = SeqSelfAttention(c, gen)
        self.norm1 = LayerNormalization(c)
        self.ff = FeedForward(c, gen)
        self.norm2 = LayerNormalization(c)

    def forward(self, h: torch.Tensor, p_attn: bool = False, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attend = seq_self_attention_kernel if p_attn else seq_self_attention
        y = attend(h, self.attention.params(), eps=_ATTN_EPS)
        y = self.norm1(h + y)
        return self.norm2(y + self.ff(y, drop_rate, generator))


class ConvStack(nn.Module):
    """``convs.{i}``: the encoder's or a decoder's convolutions."""

    def __init__(self, ins, outs, ks, gen: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(Conv(i, o, k, gen) for i, o, k in zip(ins, outs, ks))


class ResCNNBlock(nn.Module):
    def __init__(self, c: int, k: int, gen: torch.Generator):
        super().__init__()
        self.norm1 = _bn(c)
        self.conv1 = Conv(c, c, k, gen)
        self.norm2 = _bn(c)
        self.conv2 = Conv(c, c, k, gen)

    def forward(self, h: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = spatial_dropout1d(F.relu(norm(self.norm1, h)), drop_rate, generator, self.training)
        y = self.conv1.same(y)
        y = spatial_dropout1d(F.relu(norm(self.norm2, y)), drop_rate, generator, self.training)
        return h + self.conv2.same(y)


class BiLSTMBlock(nn.Module):
    def __init__(self, inp: int, gen: torch.Generator, hidden: int = 16):
        super().__init__()
        self.lstm = LSTMWeights(inp, hidden, gen, bidirectional=True)
        self.conv = Conv(2 * hidden, hidden, 1, gen)
        self.norm = _bn(hidden)

    def forward(self, h: torch.Tensor, fused="pallas", drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = bilstm(h, self.lstm.bidirectional_params(), fused=fused)
        y = dropout(y, drop_rate, generator, self.training)
        return norm(self.norm, conv1d(y, self.conv.weight, self.conv.bias))


class _Members(nn.Module):
    def __init__(self, members):
        super().__init__()
        self.members = nn.ModuleList(members)


class EQTransformer(nn.Module):
    """x (B, 3, in_samples) → (detection, P, S), each (B, in_samples), in [0, 1].

    One detection decoder + head is built per entry of ``detection_branches``
    (VolEQTransformer adds a second). ``fused`` picks the forward's route
    (``resolve_fused``); ``forward(x, fused=...)`` overrides it for one call,
    ``logits=True`` returns the heads before the sigmoid and ``stop_after``
    the intermediate of a stage. In train mode the forward is the per-branch
    program (an explicit ``fused`` other than ``"0"`` raises) with dropout
    from ``forward(..., generator=)``.

    Parameters are drawn from ``generator`` (a fresh ``torch.Generator``
    seeded 0 when omitted) with the distributions of the JAX
    ``EQTransformer.init``."""

    name = "EQTransformer"

    def __init__(
        self,
        in_channels: int = 3,
        in_samples: int = 6000,
        classes: int = 2,
        phases: str = "PS",
        norm: str = "peak",
        sampling_rate: float = 100.0,
        lstm_blocks: int = 3,
        drop_rate: float = 0.1,
        component_order: str = "ZNE",
        default_args: Optional[dict] = None,
        filters: Tuple[int, ...] = (8, 16, 16, 32, 32, 64, 64),
        kernel_sizes: Tuple[int, ...] = (11, 9, 7, 7, 5, 5, 3),
        res_cnn_kernels: Tuple[int, ...] = (3, 3, 3, 3, 2, 3, 2),
        fused: Union[str, bool, None] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.filters = tuple(filters)
        self.kernel_sizes = tuple(kernel_sizes)
        self.res_cnn_kernels = tuple(res_cnn_kernels)
        self.in_channels = in_channels
        self.in_samples = in_samples
        self.classes = classes
        self.phases = phases
        self.norm = norm
        self.sampling_rate = sampling_rate
        self.lstm_blocks = lstm_blocks
        self.drop_rate = drop_rate  # train mode only
        self.component_order = component_order
        self.default_args = dict(default_args or {})
        self.fused = fused
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        f, ks = list(self.filters), list(self.kernel_sizes)
        top = f[-1]
        self.encoder = ConvStack([in_channels] + f[:-1], f, ks, gen)
        self.res_cnn_stack = _Members(ResCNNBlock(top, k, gen) for k in self.res_cnn_kernels)
        self.bi_lstm_stack = _Members(
            BiLSTMBlock(top if i == 0 else 16, gen) for i in range(lstm_blocks)
        )
        self.transformer_d0 = Transformer(16, gen)
        self.transformer_d = Transformer(16, gen)

        for dk, ck in self.detection_branches:
            setattr(self, dk, self._decoder(gen))
            setattr(self, ck, Conv(f[0], 1, 11, gen))
        self.pick_lstms = nn.ModuleList(LSTMWeights(16, 16, gen) for _ in phases)
        self.pick_attentions = nn.ModuleList(SeqSelfAttention(16, gen) for _ in phases)
        self.pick_decoders = nn.ModuleList(self._decoder(gen) for _ in phases)
        self.pick_convs = nn.ModuleList(Conv(f[0], 1, 11, gen) for _ in phases)

        self._pool_pads = _encoder_pool_paddings(in_samples, len(f))
        self._crops = set(_decoder_crops(in_samples, len(f)))

    @property
    def labels(self) -> str:
        return "D" + self.phases  # detection + phases

    @property
    def detection_branches(self) -> Tuple[Tuple[str, str], ...]:
        """(decoder, output conv) attribute names per detection head."""
        return (("decoder_d", "conv_d"),)

    def _decoder(self, gen: torch.Generator) -> ConvStack:
        f, ks = list(self.filters), list(self.kernel_sizes)
        return ConvStack([16] + f[::-1][:-1], f[::-1], ks[::-1], gen)

    def _upconv(self, z, w, b, i: int, poly_up: bool, groups: int = 1) -> torch.Tensor:
        """Decoder layer i: 2x nearest upsampling (cropped by one where the
        encoder padded), 'same' conv, relu."""
        if poly_up:
            return F.relu(upsample2_conv1d_same(z, w, b, crop_last=i in self._crops, groups=groups))
        z = upsample_nearest(z, 2)
        if i in self._crops:
            z = z[..., :-1]
        return F.relu(conv1d_same(z, w, b, groups=groups))

    def _decode(self, z: torch.Tensor, dec: ConvStack, head: Conv, poly_up: bool,
                kernel: bool = False) -> Tuple[torch.Tensor, int]:
        """One branch's decoder and head: (B, 16, T) → (logits (B,
        in_samples), its layers that ran through ``upconv_relu``). ``kernel``:
        each layer goes through ``ops/cuda/upconv.py::upconv_relu`` (its
        kernel on the card, on the CPU its twin, which is the plain code of
        ``_upconv``) unless the wrapper refuses its shape."""
        n = 0
        for i, conv in enumerate(dec.convs):
            y = None
            if kernel:
                y = _unless_refused(upconv_relu, z.contiguous(), conv.weight, conv.bias,
                                    crop_last=int(i in self._crops))
            if y is None:
                y = self._upconv(z, conv.weight, conv.bias, i, poly_up)
            else:
                n += 1
            z = y
        return head.same(z)[:, 0], n

    def _decode_merged(self, branch_ins, decoders, heads, mode: str, poly_up: bool):
        """Every branch's decoder and head as ONE conv stack: grouped, or dense
        with block-diagonal weights. → per-branch logits (B, in_samples)."""
        groups = len(decoders)

        def merged(convs):
            bias = torch.cat([c.bias for c in convs])
            if mode == "grouped":
                return torch.cat([c.weight for c in convs]), bias, groups
            return _block_diag_kernel([c.weight for c in convs]), bias, 1

        z = torch.cat(branch_ins, dim=1)  # (B, groups * 16, T)
        for i in range(len(decoders[0].convs)):
            w, b, g = merged([d.convs[i] for d in decoders])
            z = self._upconv(z, w, b, i, poly_up, groups=g)
        w, b, g = merged(heads)
        preds = conv1d_same(z, w, b, groups=g)  # (B, groups, W)
        return [preds[:, i] for i in range(groups)]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder alone: x (B, 3, in_samples) → (B, filters[-1], T)."""
        return self._encode(x)[0]

    def _encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """The encoder → (its output, its layers that ran through
        ``convpool_relu``). The float32 eval forward sends each layer through
        ``ops/cuda/convpool.py::convpool_relu`` (its kernel on the card, on the
        CPU its twin, which is the plain code below) unless the wrapper
        refuses its shape or the input's length pads otherwise than the
        model's ``in_samples``."""
        kernel = not self.training and x.dtype == torch.float32
        h, n = x, 0
        for conv, pad in zip(self.encoder.convs, self._pool_pads):
            y = None
            if kernel and pad == h.shape[-1] % 2:
                y = _unless_refused(convpool_relu, h.contiguous(), conv.weight, conv.bias)
            if y is None:
                y = max_pool1d(F.relu(conv.same(h)), 2, padding=pad)
            else:
                n += 1
            h = y
        return h, n

    def resolve_fused(self) -> str:
        """The forward's canonical route: the ``fused`` field, else
        ``$VOLPICK_EQT_FUSED``, else ``"plstm+bandattn"``; see ``parse_fused``."""
        if self.fused is not None:
            return parse_fused(self.fused)
        env = os.environ.get("VOLPICK_EQT_FUSED", "").strip()
        return parse_fused(env) if env else DEFAULT_FUSED

    def forward(
        self,
        x: torch.Tensor,
        fused: Union[str, bool, None] = None,
        logits: bool = False,
        stop_after: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """x (B, 3, in_samples) → one (B, in_samples) curve a head. ``stop_after``
        (a diagnostic) ends the program after the named stage and returns its
        intermediate: "encoder" | "res_cnn" | "bilstm" | "transformer" (the
        trunk, (B, 16, T)) or "pick" (the tuple of per-branch decoder inputs).
        ``generator`` draws the dropout masks in train mode."""
        if stop_after is not None and stop_after not in STAGES:
            raise ValueError(f"stop_after must be one of {STAGES}")
        if self.training:
            if stop_after is not None:
                raise ValueError("stop_after is inference-only")
            explicit = fused if fused is not None else self.fused
            if explicit is not None and parse_fused(explicit) != PER_BRANCH:
                raise ValueError("fused EQTransformer path is inference-only")
            route = PER_BRANCH
        else:
            route = parse_fused(fused) if fused is not None else self.resolve_fused()
        parts = set(route.split("+"))
        rate = self.drop_rate
        fuse_lstm = "pallas" if "plstm" in parts else "lstm" in parts
        band_attn, p_attn, poly_up = "bandattn" in parts, "pattn" in parts, "polyup" in parts
        decode_mode = "grouped" if "grouped" in parts else "blockdiag" if "blockdiag" in parts else "branch"
        # the eval forward's stages, timed where x lives
        stage = (lambda name: contextlib.nullcontext()) if self.training else (
            lambda name: profiling.span(name, x.device))

        with stage("eqt.encoder") as encoder:
            h, n_convpool = self._encode(x)
            if not self.training:
                encoder.count(convpool=n_convpool if h.is_cuda else 0)
        if stop_after == "encoder":
            return h
        with stage("eqt.res_cnn"):
            for block in self.res_cnn_stack.members:
                h = block(h, rate, generator)
        if stop_after == "res_cnn":
            return h
        with stage("eqt.bilstm"):
            for block in self.bi_lstm_stack.members:
                h = block(h, fuse_lstm, rate, generator)
        if stop_after == "bilstm":
            return h
        with stage("eqt.transformer"):
            h = self.transformer_d0(h, p_attn, rate, generator)
            h = self.transformer_d(h, p_attn, rate, generator)
        if stop_after == "transformer":
            return h
        with stage("eqt.branches") as branches:
            def pick_attention(px, att):
                if band_attn:
                    return seq_self_attention_banded(px, att.params(), 3, eps=_ATTN_EPS)
                return seq_self_attention_masked(px, att.params(), 3, eps=_ATTN_EPS)

            # detection branches take the trunk output; pick branches run an LSTM
            # and local attention first (all pick LSTMs read the trunk: one merged
            # recurrence when fuse_lstm)
            branch_ins = [h for _ in self.detection_branches]
            n = len(self.pick_lstms)
            if fuse_lstm and n:
                run = lstm_branches if fuse_lstm == "pallas" else lstm_branches_reference
                px = run(
                    h,
                    torch.stack([m.weight_ih_l0 for m in self.pick_lstms]),
                    torch.stack([m.weight_hh_l0 for m in self.pick_lstms]),
                    torch.stack([m.bias_ih_l0 + m.bias_hh_l0 for m in self.pick_lstms]),
                    reverse=(False,) * n,
                ).chunk(n, dim=1)  # n x (B, 16, T)
                branch_ins += [pick_attention(px[i], att) for i, att in enumerate(self.pick_attentions)]
            else:
                for m, att in zip(self.pick_lstms, self.pick_attentions):
                    px = lstm(h, m.weight_ih_l0, m.weight_hh_l0, m.bias_ih_l0, m.bias_hh_l0,
                              kernel=False)
                    px = dropout(px, rate, generator, self.training)
                    branch_ins.append(pick_attention(px, att))
            if stop_after == "pick":
                return tuple(branch_ins)

            decoders = [getattr(self, dk) for dk, _ in self.detection_branches] + list(self.pick_decoders)
            heads = [getattr(self, ck) for _, ck in self.detection_branches] + list(self.pick_convs)
            # the per-branch decoders of the float32 eval forward without "polyup"
            # take upconv_relu unless it refuses the layer's shape, one launch a layer on the card
            kernel = decode_mode == "branch" and not poly_up and not self.training and h.dtype == torch.float32
            n_upconv = 0
            if decode_mode == "branch":
                preds = []
                for z, d, c in zip(branch_ins, decoders, heads):
                    p, n = self._decode(z, d, c, poly_up, kernel)
                    preds.append(p)
                    n_upconv += n
            else:
                preds = self._decode_merged(branch_ins, decoders, heads, decode_mode, poly_up)
            if not self.training:
                branches.count(upconv=n_upconv if h.is_cuda else 0)
            return tuple(preds if logits else [torch.sigmoid(p) for p in preds])


class VolEQTransformer(EQTransformer):
    """EQTransformer with a second detection head: x → (rg_detection,
    lp_detection, P, S), regular (VT) and long-period events.

    Port of ``volpick_tpu/models/eqtransformer.py::VolEQTransformer``: the
    shared trunk feeds ``decoder_d``/``conv_d`` and ``decoder_lp``/``conv_lp``
    plus the P/S branches."""

    name = "VolEQTransformer"

    @property
    def detection_branches(self) -> Tuple[Tuple[str, str], ...]:
        return (("decoder_d", "conv_d"), ("decoder_lp", "conv_lp"))
