"""JAX parameter trees ↔ the port's models, and the JAX trainer's native
``.npz.v1`` export read without JAX.

``jax_tree_from_model`` is the way back: a port model's parameters and
BatchNorm statistics as the JAX ``init`` tree (numpy leaves), and
``model_args_of`` its constructor arguments under the JAX dataclass fields;
``train/model_io.py::export_pretrained`` writes both.

EQTransformer and PhaseNet: the exact inverses of
``volpick_tpu/models/torch_import.py::import_eqtransformer`` /
``import_phasenet``. The JAX trees are already in torch layout (NCW, OIH conv
kernels, gate order i, f, g, o), so leaves are copied as they are and only
the names change, except PhaseNet's transposed convs: the JAX tree holds them
transposed and flipped, (O, I, K) reversed in K, and they go back to torch's
ConvTranspose1d (I, O, K). TPUPickNet's state-dict names are the flattened
tree paths themselves. Leaves may be numpy arrays or anything ``np.asarray``
accepts (pass a JAX tree through ``jax.device_get`` first).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from volpick_tpu_torch.models.eqtransformer import EQTransformer, VolEQTransformer
from volpick_tpu_torch.models.phasenet import PhaseNet
from volpick_tpu_torch.models.tpupicknet import TPUPickNet

ARCHS = {"phasenet": PhaseNet, "eqtransformer": EQTransformer,
         "voleqtransformer": VolEQTransformer, "tpupicknet": TPUPickNet}


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(p["scale"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])
    sd[f"{prefix}.running_mean"] = _tensor(p["mean"])
    sd[f"{prefix}.running_var"] = _tensor(p["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def eqtransformer_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``EQTransformer.init``-shaped tree → ``EQTransformer.load_state_dict`` input."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value) -> None:
        sd[key] = _tensor(value)

    def conv(prefix: str, p: Dict) -> None:
        put(f"{prefix}.weight", p["w"])
        put(f"{prefix}.bias", p["b"])

    def bn(prefix: str, p: Dict) -> None:
        _bn(sd, prefix, p)

    def lstm(prefix: str, p: Dict, bidirectional: bool = False) -> None:
        for suf, key in (("_l0", ""), ("_l0_reverse", "_rev"))[: 2 if bidirectional else 1]:
            put(f"{prefix}.weight_ih{suf}", p[f"w_ih{key}"])
            put(f"{prefix}.weight_hh{suf}", p[f"w_hh{key}"])
            put(f"{prefix}.bias_ih{suf}", p[f"b_ih{key}"])
            put(f"{prefix}.bias_hh{suf}", p[f"b_hh{key}"])

    def attention(prefix: str, p: Dict) -> None:
        for k in ("Wx", "Wt", "bh", "Wa", "ba"):
            put(f"{prefix}.{k}", p[k])

    def transformer(prefix: str, p: Dict) -> None:
        attention(f"{prefix}.attention", p["attention"])
        for norm in ("norm1", "norm2"):
            put(f"{prefix}.{norm}.gamma", p[norm]["gamma"])
            put(f"{prefix}.{norm}.beta", p[norm]["beta"])
        for lin in ("lin1", "lin2"):
            put(f"{prefix}.ff.{lin}.weight", p["ff"][lin]["w"])
            put(f"{prefix}.ff.{lin}.bias", p["ff"][lin]["b"])

    for i, p in enumerate(params["encoder"]):
        conv(f"encoder.convs.{i}", p)
    for j, block in enumerate(params["res_cnn"]):
        pre = f"res_cnn_stack.members.{j}"
        bn(f"{pre}.norm1", block["norm1"])
        conv(f"{pre}.conv1", block["conv1"])
        bn(f"{pre}.norm2", block["norm2"])
        conv(f"{pre}.conv2", block["conv2"])
    for j, block in enumerate(params["bilstm"]):
        pre = f"bi_lstm_stack.members.{j}"
        lstm(f"{pre}.lstm", block["lstm"], bidirectional=True)
        conv(f"{pre}.conv", block["conv"])
        bn(f"{pre}.norm", block["norm"])
    transformer("transformer_d0", params["transformer_d0"])
    transformer("transformer_d", params["transformer_d"])
    for i, p in enumerate(params["decoder_d"]):
        conv(f"decoder_d.convs.{i}", p)
    conv("conv_d", params["conv_d"])
    for k, p in enumerate(params["pick_lstms"]):
        lstm(f"pick_lstms.{k}", p)
    for k, p in enumerate(params["pick_attentions"]):
        attention(f"pick_attentions.{k}", p)
    for k, dec in enumerate(params["pick_decoders"]):
        for i, p in enumerate(dec):
            conv(f"pick_decoders.{k}.convs.{i}", p)
    for k, p in enumerate(params["pick_convs"]):
        conv(f"pick_convs.{k}", p)
    return sd


def voleqtransformer_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``VolEQTransformer.init``-shaped tree → ``VolEQTransformer.load_state_dict`` input."""
    sd = eqtransformer_state_dict_from_jax(params)
    for i, p in enumerate(params["decoder_lp"]):
        sd[f"decoder_lp.convs.{i}.weight"] = _tensor(p["w"])
        sd[f"decoder_lp.convs.{i}.bias"] = _tensor(p["b"])
    sd["conv_lp.weight"] = _tensor(params["conv_lp"]["w"])
    sd["conv_lp.bias"] = _tensor(params["conv_lp"]["b"])
    return sd


def phasenet_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``PhaseNet.init``-shaped tree → ``PhaseNet.load_state_dict`` input."""
    sd: Dict[str, torch.Tensor] = {
        "inc.weight": _tensor(params["inc"]["w"]),
        "inc.bias": _tensor(params["inc"]["b"]),
        "out.weight": _tensor(params["out"]["w"]),
        "out.bias": _tensor(params["out"]["b"]),
    }
    _bn(sd, "in_bn", params["in_bn"])
    for i, stage in enumerate(params["down"]):
        sd[f"down_branch.{i}.0.weight"] = _tensor(stage["conv_same"]["w"])
        _bn(sd, f"down_branch.{i}.1", stage["bn1"])
        if "conv_down" in stage:
            sd[f"down_branch.{i}.2.weight"] = _tensor(stage["conv_down"]["w"])
            _bn(sd, f"down_branch.{i}.3", stage["bn2"])
    for i, stage in enumerate(params["up"]):
        w = np.asarray(stage["conv_up"]["w"], dtype=np.float32)  # (O, I, K), K reversed
        sd[f"up_branch.{i}.0.weight"] = _tensor(w[:, :, ::-1].transpose(1, 0, 2))
        _bn(sd, f"up_branch.{i}.1", stage["bn1"])
        sd[f"up_branch.{i}.2.weight"] = _tensor(stage["conv_same"]["w"])
        _bn(sd, f"up_branch.{i}.3", stage["bn2"])
    return sd


def _flatten(tree, prefix: str = "") -> Dict:
    """Tree → {"a.0.b": leaf}, the key scheme of ``train/model_io.py``."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flatten(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flatten(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _unflatten(flat: Dict) -> Dict:
    """Inverse of ``_flatten``: all-digit path parts index lists."""
    root: Dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def tpupicknet_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``TPUPickNet.init``-shaped tree → ``TPUPickNet.load_state_dict`` input."""
    return {k: _tensor(v) for k, v in _flatten(params).items()}


STATE_DICT_FROM_JAX = {
    "phasenet": phasenet_state_dict_from_jax,
    "eqtransformer": eqtransformer_state_dict_from_jax,
    "voleqtransformer": voleqtransformer_state_dict_from_jax,
    "tpupicknet": tpupicknet_state_dict_from_jax,
}


# the JAX dataclass fields of each architecture that a .json.v1 records
MODEL_FIELDS = {
    "eqtransformer": ("in_channels", "in_samples", "classes", "phases", "norm", "sampling_rate",
                      "lstm_blocks", "drop_rate", "component_order", "filters", "kernel_sizes",
                      "res_cnn_kernels"),
    "phasenet": ("in_channels", "classes", "phases", "norm", "sampling_rate", "in_samples", "depth",
                 "kernel_size", "stride", "filters_root", "component_order"),
    "tpupicknet": ("in_channels", "in_samples", "classes", "phases", "norm", "sampling_rate",
                   "d_model", "n_heads", "n_layers", "mlp_ratio", "patch_stride", "component_order",
                   "attn", "default_classify_batch"),
}
MODEL_FIELDS["voleqtransformer"] = MODEL_FIELDS["eqtransformer"]


def model_args_of(model: torch.nn.Module) -> Dict:
    """The model's constructor arguments under the JAX dataclass's field names."""
    return {k: getattr(model, k) for k in MODEL_FIELDS[model.name.lower()]}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _conv_tree(m) -> Dict:
    out = {"w": _np(m.weight)}
    if getattr(m, "bias", None) is not None:
        out["b"] = _np(m.bias)
    return out


def _bn_tree(m) -> Dict:
    return {"scale": _np(m.weight), "bias": _np(m.bias), "mean": _np(m.running_mean),
            "var": _np(m.running_var)}


def _eqtransformer_tree(model) -> Dict:
    def lstm(m, bidirectional=False):
        out = {}
        for suf, key in (("_l0", ""), ("_l0_reverse", "_rev"))[: 2 if bidirectional else 1]:
            for torch_name, jax_name in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                         ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                out[f"{jax_name}{key}"] = _np(getattr(m, f"{torch_name}{suf}"))
        return out

    def attention(m):
        return {k: _np(getattr(m, k)) for k in ("Wx", "Wt", "bh", "Wa", "ba")}

    def transformer(m):
        return {
            "attention": attention(m.attention),
            "norm1": {"gamma": _np(m.norm1.gamma), "beta": _np(m.norm1.beta)},
            "ff": {lin: {"w": _np(getattr(m.ff, lin).weight), "b": _np(getattr(m.ff, lin).bias)}
                   for lin in ("lin1", "lin2")},
            "norm2": {"gamma": _np(m.norm2.gamma), "beta": _np(m.norm2.beta)},
        }

    tree = {
        "encoder": [_conv_tree(c) for c in model.encoder.convs],
        "res_cnn": [{"norm1": _bn_tree(b.norm1), "conv1": _conv_tree(b.conv1),
                     "norm2": _bn_tree(b.norm2), "conv2": _conv_tree(b.conv2)}
                    for b in model.res_cnn_stack.members],
        "bilstm": [{"lstm": lstm(b.lstm, True), "conv": _conv_tree(b.conv), "norm": _bn_tree(b.norm)}
                   for b in model.bi_lstm_stack.members],
        "transformer_d0": transformer(model.transformer_d0),
        "transformer_d": transformer(model.transformer_d),
        "pick_lstms": [lstm(m) for m in model.pick_lstms],
        "pick_attentions": [attention(m) for m in model.pick_attentions],
        "pick_decoders": [[_conv_tree(c) for c in d.convs] for d in model.pick_decoders],
        "pick_convs": [_conv_tree(c) for c in model.pick_convs],
    }
    for dk, ck in model.detection_branches:
        tree[dk] = [_conv_tree(c) for c in getattr(model, dk).convs]
        tree[ck] = _conv_tree(getattr(model, ck))
    return tree


def _phasenet_tree(model) -> Dict:
    down = []
    for conv_same, bn1, conv_down, bn2 in model.down_branch:
        stage = {"conv_same": _conv_tree(conv_same), "bn1": _bn_tree(bn1)}
        if conv_down is not None:
            stage.update(conv_down=_conv_tree(conv_down), bn2=_bn_tree(bn2))
        down.append(stage)
    up = []
    for conv_up, bn1, conv_same, bn2 in model.up_branch:
        w = _np(conv_up.weight)  # torch (I, O, K) → JAX (O, I, K) reversed in K
        up.append({"conv_up": {"w": np.ascontiguousarray(w.transpose(1, 0, 2)[:, :, ::-1])},
                   "bn1": _bn_tree(bn1), "conv_same": _conv_tree(conv_same), "bn2": _bn_tree(bn2)})
    return {"inc": _conv_tree(model.inc), "in_bn": _bn_tree(model.in_bn), "down": down, "up": up,
            "out": _conv_tree(model.out)}


def jax_tree_from_model(model: torch.nn.Module) -> Dict:
    """The model's parameters and BatchNorm statistics as the JAX ``init`` tree
    of its architecture, numpy float32 leaves: the inverse of the
    ``*_state_dict_from_jax`` functions."""
    arch = model.name.lower()
    if arch in ("eqtransformer", "voleqtransformer"):
        return _eqtransformer_tree(model)
    if arch == "phasenet":
        return _phasenet_tree(model)
    return _unflatten({k: _np(v) for k, v in model.state_dict().items()})


def load_npz_v1(json_path, npz_path) -> Tuple[str, torch.nn.Module]:
    """Read a native pretrained pair written by the JAX trainer's
    ``train/model_io.py::export_pretrained`` → (arch, model on the CPU in
    eval mode), loaded with ``strict=True``.

    As ``load_pretrained_npz`` does: the architecture is
    ``meta["architecture"]``, else sniffed from the kwargs (``d_model`` →
    TPUPickNet, ``lstm_blocks`` → EQTransformer, else PhaseNet; the two EQT
    variants share kwargs), and list kwargs become tuples again."""
    with open(json_path) as f:
        meta = json.load(f)
    margs = {k: tuple(v) if isinstance(v, list) else v for k, v in meta.get("model_args", {}).items()}
    arch = str(meta.get("architecture", "")).lower()
    if arch not in ARCHS:
        if "d_model" in margs:
            arch = "tpupicknet"
        elif "lstm_blocks" in margs:
            arch = "eqtransformer"
        else:
            arch = "phasenet"
    model = ARCHS[arch](default_args=dict(meta.get("default_args", {})), **margs)
    with np.load(npz_path) as data:
        params = _unflatten({k: data[k] for k in data.files})
    model.load_state_dict(STATE_DICT_FROM_JAX[arch](params), strict=True)
    return arch, model.eval()
