"""JAX parameter tree → state dict of the port's EQTransformer.

The exact inverse of ``volpick_tpu/models/torch_import.py::import_eqtransformer``.
The JAX tree is already in torch layout (NCW, OIH conv kernels, gate order
i, f, g, o), so every leaf is copied as is; only the names change. Leaves may
be numpy arrays or anything ``np.asarray`` accepts (pass the JAX tree through
``jax.device_get`` first); this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def eqtransformer_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """``EQTransformer.init``-shaped tree → ``EQTransformer.load_state_dict`` input."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value) -> None:
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def conv(prefix: str, p: Dict) -> None:
        put(f"{prefix}.weight", p["w"])
        put(f"{prefix}.bias", p["b"])

    def bn(prefix: str, p: Dict) -> None:
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        put(f"{prefix}.running_mean", p["mean"])
        put(f"{prefix}.running_var", p["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

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
