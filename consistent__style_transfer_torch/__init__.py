"""PyTorch + CUDA port of the style-transfer framework, for NVIDIA Hopper.

It sits beside the JAX package ``consistent__style_transfer_tpu``, keeps its
module names so that each module's counterpart is easy to find, and imports
nothing of it (nor jax, flax, optax or orbax). The port grows slice by slice
(ROADMAP.md). Ported so far (``python -m consistent__style_transfer_torch``):
greedy style-transfer serving, ``serve`` and ``infer``, whose greedy decode
head runs as a hand-written CUDA kernel (``kernels/decode_step.py``,
``csrc/decode_step.cu``); and the pretrain stage, ``vocab``, ``w2v`` and
``pretrain``, whose WMD labels come from a hand-written CUDA Sinkhorn kernel
(``kernels/sinkhorn.py``, ``csrc/sinkhorn.cu``); and the generator's
training stages, ``warmup`` and ``optimize``. Each kernel runs whenever its
tensors are on the card.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` / ``Config.device = "cpu"``); without CUDA and without that
request they raise rather than carry on on the CPU.
"""

__version__ = "0.1.0"

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3

PAD = "<pad>"
BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"

SPECIAL_TOKENS = (PAD, BOS, EOS, UNK)
