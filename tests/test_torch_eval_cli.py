"""The port's eval commands through its CLI on the CPU, in a process where
jax, flax, optax, orbax, the JAX package, scikit-learn, gensim, fasttext and
pyemd cannot be imported: a tiny pretrain, warmup and infer, then
``eval-prepare``, ``eval``, ``run --epochs 1`` and ``ablate --epochs 1``."""

from test_torch_imports import _run_blocked  # skips the module where torch is absent

_BLOCKED_EVAL = r"""
import os
import torch
from consistent__style_transfer_torch import cli
from consistent__style_transfer_torch.evaluate.prepare import eval_paths
from consistent__style_transfer_torch.text.fasttext_cls import FastTextClassifier

torch.set_num_threads(1)  # the test workers share the cores
root = %r
os.makedirs(os.path.join(root, "data", "tiny"))
for split, n in (("train", 8), ("dev", 4), ("test", 4)):
    for label, words in ((0, "bad awful cold slow rude"), (1, "good great warm quick kind")):
        with open(os.path.join(root, "data", "tiny", f"style.{split}.{label}"), "w") as f:
            for i in range(n):
                w = words.split()
                print(f"the food was {w[i %% 5]} and {w[(i + 2) %% 5]} .", file=f)
flags = ["--dataset", "tiny", "--data_dir", os.path.join(root, "data"),
         "--dump_dir", os.path.join(root, "dump"), "--log_dir", os.path.join(root, "log"),
         "--out_dir", os.path.join(root, "out"), "--device", "cpu", "--max_len", "8",
         "--batch_size", "4", "--vocab_size", "60", "--scorer_layers", "1",
         "--scorer_d_model", "16", "--scorer_heads", "2", "--dtype", "float32",
         "--warmup_batch_size", "4", "--epochs", "1"]
cli.main(["pretrain", *flags])
cli.main(["warmup", *flags])
cli.main(["infer", *flags])
cli.main(["eval-prepare", *flags])
paths = eval_paths(os.path.join(root, "evaluate_runtime"), "tiny", "v0")
for key in ("classifier", "lexicon", "vectorizer", "mask_w2v", "adv_model"):
    assert os.path.exists(paths[key]), key
assert FastTextClassifier.load_model(paths["classifier"]).fit_meta["sgd_path"] == "sequential"
print("EVAL_V0")
cli.main(["eval", *flags])
cli.main(["run", *flags, "--ver", "v1"])
with open(os.path.join(root, "out", "tiny-v1.txt")) as f:
    results = f.read()
assert "STI" in results and "CP" in results and "NT" in results, results
cli.main(["ablate", *flags])
for ver in cli.ABLATIONS:
    adv = eval_paths(os.path.join(root, "evaluate_runtime"), "tiny", ver)["adv_model"]
    assert os.path.exists(adv), adv
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("EVALUATED")
"""


def test_eval_commands_run_with_jax_and_sklearn_blocked(tmp_path):
    out = _run_blocked(_BLOCKED_EVAL % str(tmp_path))
    assert "EVALUATED" in out
    # eval after EVAL_V0, then run's and each of the six ablations' evals
    evals = out.split("EVAL_V0")[1]
    assert evals.count("STI (higher is better)") == 2 + 6
    assert evals.count("self-BLEU") == 8 and "ref-BLEU" not in evals  # no references here
