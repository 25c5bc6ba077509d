"""The book dataset's kernel shapes on the card (``data/book``: B=128, the
WMD labeler's 45 atoms a side): the labeler on the card against the CPU on
real book label batches, and the decode head at B=128 against its plain
version. The graphed steps at book's L=30 are cases of
tests/test_torch_graph_steps_cuda.py (greedy serving, the warmup step) and
tests/test_torch_megastep_cuda.py (the fused optimize step). Every test
needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a machine that has only PyTorch
(tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_book_cuda.py

Tolerances:
- WMD labels: rtol 1e-4, atol 1e-4 (tests/test_torch_wmd_labels.py: D and
  the Sinkhorn summed in another order, on the card in base 2); fallback
  rows exactly;
- the decode head: float32 ids equal and h within 1e-4; bf16 h within 2e-2
  of the plain bf16 h relative to its size, and a differing id a near-tie
  (1e-2) of the float32 logits (tests/test_torch_decode_head_cuda.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.data.noise import transfer_noise_arrays  # noqa: E402
from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler  # noqa: E402
from consistent__style_transfer_torch.kernels.decode_step import (  # noqa: E402
    decode_head_reference,
    fused_decode_logits,
)
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.text.word2vec import train_token_w2v  # noqa: E402
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK_L, BOOK_B = 30, 128
ATOMS = BOOK_L + BOOK_L // 2  # the labeler's capacity, train/pretrain.py
NOISE_LEN = BOOK_L + max(4, BOOK_L // 2)
LINES = 300  # committed book train lines a style


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    """A BPE and a word2vec (numpy trainer, one epoch) on the first LINES
    lines of each committed book train file, and those lines' ids at L=30."""
    root = tmp_path_factory.mktemp("book")
    files = []
    for k in (0, 1):
        with open(os.path.join(ROOT, "data", "book", f"style.train.{k}"), encoding="utf-8") as f:
            lines = [next(f) for _ in range(LINES)]
        files.append(str(root / f"style.train.{k}"))
        with open(files[-1], "w", encoding="utf-8") as f:
            f.writelines(lines)
    tok = BPETokenizer.train(files, 900)
    w2v = train_token_w2v(files, tok, epochs=1, seed=4, prefer_native=False, dim=32,
                          min_count=1)
    w2v.init_sims()
    sents = [tok.encode(line.strip())[:BOOK_L] for path in files
             for line in open(path, encoding="utf-8")]
    ids = np.zeros((len(sents), BOOK_L), np.int32)
    lens = np.array([len(s) for s in sents], np.int32)
    for i, s in enumerate(sents):
        ids[i, : len(s)] = s
    return tok, w2v, ids, lens


def test_labeler_on_the_card_equals_the_cpu_at_45_atoms(cuda_device, book):
    """Two real label batches of 128 book pairs, noised as the pretrain
    collate noises them to 45 tokens; some pair has a side over 32 valid
    atoms (the kernel's shared-memory loop)."""
    tok, w2v, ids, lens = book
    card = SinkhornWmdLabeler(w2v, tok, max_atoms=ATOMS, device=cuda_device)
    cpu = SinkhornWmdLabeler(w2v, tok, max_atoms=ATOMS, device="cpu")
    rng = np.random.default_rng(0)
    over_32 = 0
    for start in (0, LINES - BOOK_B // 2):
        rows = slice(start, start + BOOK_B)
        nx1, nl1 = transfer_noise_arrays(ids[rows], lens[rows], 0.15, rng, NOISE_LEN)
        nx2, nl2 = transfer_noise_arrays(ids[rows], lens[rows], 0.15, rng, NOISE_LEN)
        p, q, _, _ = card.pair_inputs(nx1, nl1, nx2, nl2)
        assert p.shape == q.shape == (BOOK_B, ATOMS)
        over_32 += int((((p > 0).sum(-1) > 32) | ((q > 0).sum(-1) > 32)).sum())
        launches = total("kernel.sinkhorn_cuda")
        got = card.label_pairs(nx1, nl1, nx2, nl2)
        assert total("kernel.sinkhorn_cuda") == launches + 1
        want = cpu.label_pairs(nx1, nl1, nx2, nl2)
        assert got.device.type == "cuda" and got.shape == (BOOK_B,)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert over_32 > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [7919, 10000])
def test_decode_head_at_b128_matches_the_plain_version(cuda_device, dtype, V):
    g = torch.Generator().manual_seed(V)

    def u(shape, bound):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(cuda_device, dtype)

    x, w1, b1, w2 = u((BOOK_B, 1024), 1.0), u((512, 1024), 1024 ** -0.5), \
        u((512,), 1024 ** -0.5), u((V, 512), 512 ** -0.5)
    launches = total("kernel.fused_decode_logits")
    ids, h = fused_decode_logits(x, w1, b1, w2)
    assert total("kernel.fused_decode_logits") == launches + 1
    ref_ids, ref_h = decode_head_reference(x, w1, b1, w2)
    assert ids.shape == (BOOK_B,) and ids.dtype == torch.int32 and h.shape == (BOOK_B, 512)
    if dtype == torch.float32:
        assert torch.equal(ids, ref_ids)
        assert float((h - ref_h).abs().max()) <= 1e-4
        return
    assert float((h - ref_h.float()).abs().max()) <= 2e-2 * float(ref_h.float().abs().max())
    logits = decode_head_reference(x.float(), w1.float(), b1.float(), w2.float())[1] @ w2.float().t()
    rows = (ids != ref_ids).nonzero().flatten()
    if rows.numel():
        gap = logits[rows].max(-1).values - logits[rows, ids[rows].long()]
        assert float(gap.max()) <= 1e-2
