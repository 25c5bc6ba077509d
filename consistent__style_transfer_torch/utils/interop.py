"""Weight bridge from the JAX package's flax params to the port's state dicts.

The port's own copy of the mappings in
``consistent__style_transfer_tpu/utils/torch_interop.py`` (``_t``,
``_conv``, ``_lstm``, ``_transformer_out`` and the ``*_to_state_dict``
exporters of the generator, the three scorers and the discriminator), and
the transformer generator's by name (it has no exporter there): flax
``Dense.kernel`` is
(in, out) and a torch ``Linear.weight`` (out, in); a flax ``Conv.kernel``
(k, in, out) is a torch ``Conv2d.weight`` (out, 1, k, in); the LSTM gate
order (i, f, g, o) is the same in both, so an LSTM kernel only transposes;
a flax ``LayerNorm`` ``scale`` is the torch ``weight``. The keys are the
reference's state-dict keys, which are the port's attribute names, so each
result loads into the port's module with ``strict=True``. Takes nested dicts
of numpy arrays; imports no JAX.

The eval harness's fitted objects come across as numpy too:
:func:`vectorizer_from_vocabulary` and :func:`l1_lr_from_arrays` build the
port's vectorizer and L1 logistic regression from a fitted scikit-learn
``CountVectorizer``'s ``vocabulary_`` and a ``LogisticRegression``'s
``coef_``, ``intercept_`` and ``classes_`` (the JAX package pickles those
objects; the port never loads scikit-learn).
"""

from __future__ import annotations

import numpy as np
import torch

from ..evaluate.lexicon import BinaryUnigramVectorizer, L1LogisticRegression


def _t(x) -> np.ndarray:  # flax kernel (in, out) -> torch linear weight (out, in)
    return np.asarray(x).T


def _conv(x) -> np.ndarray:  # flax (k, in, out) -> torch (out, 1, k, in)
    return np.asarray(x).transpose(2, 0, 1)[:, None, :, :]


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
    return _tensors(sd)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32) for k, v in sd.items()}


def _transformer(p: dict, prefix: str) -> dict:
    """Encoder ``layer_{i}`` subtrees -> ``<prefix>.layers.{i}.*``; the layer
    count is read from the tree."""
    out = {}
    n_layers = sum(1 for k in p if k.startswith("layer_"))
    for i in range(n_layers):
        L = p[f"layer_{i}"]
        pre = f"{prefix}.layers.{i}"
        out[f"{pre}.self_attn.in_proj_weight"] = _t(L["self_attn"]["in_proj"]["kernel"])
        out[f"{pre}.self_attn.in_proj_bias"] = np.asarray(L["self_attn"]["in_proj"]["bias"])
        out[f"{pre}.self_attn.out_proj.weight"] = _t(L["self_attn"]["out_proj"]["kernel"])
        out[f"{pre}.self_attn.out_proj.bias"] = np.asarray(L["self_attn"]["out_proj"]["bias"])
        for lin in ("linear1", "linear2"):
            out[f"{pre}.{lin}.weight"] = _t(L[lin]["kernel"])
            out[f"{pre}.{lin}.bias"] = np.asarray(L[lin]["bias"])
        for norm in ("norm1", "norm2"):
            out[f"{pre}.{norm}.weight"] = np.asarray(L[norm]["scale"])
            out[f"{pre}.{norm}.bias"] = np.asarray(L[norm]["bias"])
    return out


def classifier_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``TextCNN`` variables -> the port's :class:`~..models.TextCNN`
    state dict."""
    p = params["params"]
    sd = {
        "embedding.weight": np.asarray(p["embedding"]["embedding"]),
        "out.weight": _t(p["out"]["kernel"]),
        "out.bias": np.asarray(p["out"]["bias"]),
    }
    for i, k in enumerate((3, 4, 5)):
        sd[f"convs.{i}.weight"] = _conv(p[f"conv_{k}"]["kernel"])
        sd[f"convs.{i}.bias"] = np.asarray(p[f"conv_{k}"]["bias"])
    return _tensors(sd)


def matcher_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``PairMatcher`` variables -> the port's
    :class:`~..models.PairMatcher` state dict."""
    p = params["params"]
    sd = {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        "posit_embedding.weight": np.asarray(p["posit_embedding"]["embedding"]),
        "segment_embedding.weight": np.asarray(p["segment_embedding"]["embedding"]),
        "hidden2logits.weight": _t(p["hidden2logits"]["kernel"]),
        "hidden2logits.bias": np.asarray(p["hidden2logits"]["bias"]),
    }
    sd.update(_transformer(p["matcher"], "matcher"))
    return _tensors(sd)


def discriminator_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``RelGANDiscriminator`` variables -> the port's
    :class:`~..models.RelGANDiscriminator` state dict. The flax ``embeddings``
    param (V, 128) is the torch ``Linear(V, 128)`` weight transposed."""
    p = params["params"]
    sd = {"embeddings.weight": _t(p["embeddings"])}
    for name in ("highway", "feature2out", "out2logits"):
        sd[f"{name}.weight"] = _t(p[name]["kernel"])
        sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    for i, f in enumerate((2, 3, 4, 5)):
        sd[f"convs.{i}.weight"] = _conv(p[f"conv_{f}"]["kernel"])
        sd[f"convs.{i}.bias"] = np.asarray(p[f"conv_{f}"]["bias"])
    return _tensors(sd)


def lm_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``TransformerLM`` variables -> the port's
    :class:`~..models.TransformerLM` state dict."""
    p = params["params"]
    sd = {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        "posit_embedding.weight": np.asarray(p["posit_embedding"]["embedding"]),
        "fwd.weight": _t(p["fwd"]["kernel"]),
        "fwd.bias": np.asarray(p["fwd"]["bias"]),
    }
    sd.update(_transformer(p["lm"], "lm"))
    return _tensors(sd)


def transformer_generator_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``TransformerSeq2Seq`` variables -> the port's
    :class:`~..models.seq2seq_transformer.TransformerSeq2Seq` state dict.
    The port's attribute names are the flax tree's, joined by dots
    (``dec_3.cross_attn.out``); a Dense ``kernel`` becomes the transposed
    ``weight``, a LayerNorm ``scale`` and an Embed ``embedding`` the
    ``weight``, a ``bias`` stays. The JAX package has no counterpart
    (its ``generator_to_state_dict`` is the LSTM's): the ``.pth`` of this
    backbone is the port's own format."""
    sd = {}

    def walk(tree: dict, prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
            elif name == "kernel":
                sd[f"{prefix}weight"] = _t(value)
            else:
                sd[prefix + {"scale": "weight", "embedding": "weight"}.get(name, name)] = \
                    np.asarray(value)

    walk(params["params"], "")
    return _tensors(sd)


def vectorizer_from_vocabulary(vocabulary_: dict) -> BinaryUnigramVectorizer:
    """A fitted ``CountVectorizer(binary=True)``'s ``vocabulary_`` (token ->
    column) -> the port's :class:`BinaryUnigramVectorizer`."""
    return BinaryUnigramVectorizer({str(w): int(i) for w, i in vocabulary_.items()})


def l1_lr_from_arrays(coef, intercept, classes) -> L1LogisticRegression:
    """A fitted binary ``LogisticRegression``'s ``coef_`` (1, n),
    ``intercept_`` (1,) and ``classes_`` (2,) -> the port's
    :class:`L1LogisticRegression` (float64)."""
    lr = L1LogisticRegression()
    lr.coef_ = np.asarray(coef, np.float64).reshape(1, -1)
    lr.intercept_ = np.asarray(intercept, np.float64).reshape(1)
    lr.classes_ = np.asarray(classes)
    return lr
