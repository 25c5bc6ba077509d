"""Weight bridge from the JAX package's flax params to the port's state dicts.

The port's own copy of the generator mapping in
``consistent__style_transfer_tpu/utils/torch_interop.py`` (``_t``, ``_lstm``
and ``generator_to_state_dict``): flax ``Dense.kernel`` is (in, out) and a
torch ``Linear.weight`` (out, in); the LSTM gate order (i, f, g, o) is the
same in both, so an LSTM kernel only transposes. The keys are the reference's
state-dict keys, which are the port's attribute names, so the result loads
into :class:`~..models.generator.DenoiseSeq2Seq` with ``strict=True``.
Takes nested dicts of numpy arrays; imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> np.ndarray:  # flax kernel (in, out) -> torch linear weight (out, in)
    return np.asarray(x).T


def _lstm(prefix: str, cell: dict, suffix: str = "") -> dict:
    return {
        f"{prefix}.weight_ih_l0{suffix}": _t(cell["ih"]["kernel"]),
        f"{prefix}.bias_ih_l0{suffix}": np.asarray(cell["ih"]["bias"]),
        f"{prefix}.weight_hh_l0{suffix}": _t(cell["hh"]["kernel"]),
        f"{prefix}.bias_hh_l0{suffix}": np.asarray(cell["hh"]["bias"]),
    }


def generator_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``DenoiseSeq2Seq`` variables ``{"params": {...}}`` (nested dicts
    of numpy arrays) -> the port's generator state dict (f32 CPU tensors)."""
    p = params["params"]
    sd = {
        "start_embedding.weight": np.asarray(p["start_embedding"]["embedding"]),
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        "enc_style_embedding.weight": np.asarray(p["enc_style_embedding"]["embedding"]),
        "style_embedding.weight": np.asarray(p["style_embedding"]["embedding"]),
        "transfer.weight": _t(p["transfer"]["kernel"]),
        "fn_1.weight": _t(p["decoder"]["fn_1"]["kernel"]),
        "fn_1.bias": np.asarray(p["decoder"]["fn_1"]["bias"]),
        "fn_2.weight": _t(p["decoder"]["fn_2"]["kernel"]),
    }
    sd.update(_lstm("encoder", p["encoder_fwd"]["cell"]))
    sd.update(_lstm("encoder", p["encoder_bwd"]["cell"], "_reverse"))
    sd.update(_lstm("decoder", p["decoder"]["cell"]))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
