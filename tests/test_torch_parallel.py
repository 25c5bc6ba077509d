"""The port's mesh and tensor parallelism (``consistent__style_transfer_torch/
parallel/``) against the JAX package's ``parallel/``, on the CPU.

- The mesh: shapes for world sizes 1 and 2 ((2, 1), (1, 2)); a mesh the
  world cannot make raises; rank r sits where the JAX package puts device r
  (``devices.reshape(n_data, n_model)``); the rows of a data rank are the
  rows the JAX ``shard_batch`` puts on a device of that data index.
- The TP rules: every parameter of the port's TransformerLM, PairMatcher,
  generator, classifier and discriminator gets the layout the JAX
  ``param_shardings`` gives the same tensor on the conftest's virtual
  ``make_mesh(1, 2)``, element for element through the port's weight
  mapping (``utils/interop.py``, which transposes each kernel).
- Two gloo ranks: the TP forward of the LM equals the replicated one (the
  Q/K/V rows that ``Shard(0)`` of ``in_proj_weight`` splits are a layout,
  not a head split); ``optimize_step_on_mesh`` at (2, 1) and (1, 2), 2 steps
  each in float32 with dropout off and the coins given, within rel 1e-5 of
  the (1, 1) run, the named parameters ``Shard``ed at (1, 2), and its
  checkpoint restored and continued; ``serve`` raises under world 2.
- ``--n_data 2`` without the launcher raises.

The two-rank runs start their processes with the ``spawn`` context (the
pytest process holds JAX), rendezvous on a ``file://`` store in the test's
tmp dir, and import no JAX; every comparison with the JAX package runs here.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.parallel import mesh as pmesh  # noqa: E402
from consistent__style_transfer_torch.parallel import sharding  # noqa: E402
from consistent__style_transfer_torch.parallel.exercise import optimize_step_on_mesh  # noqa: E402

V, L = 64, 6
EXERCISE = dict(n_steps=2, batch=4, dtype="float32", p_drop=0.0, clip=0.1, device="cpu")
REL = 1e-5
SHARDED = ("self_attn.in_proj_weight", "self_attn.in_proj_bias", "self_attn.out_proj.weight",
           "linear1.weight", "linear1.bias", "linear2.weight", "fwd.weight", "fwd.bias",
           "fn_2.weight")


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0) -> dict:
    """Run ``fn(rank, world, store, *args)`` in ``world`` spawned processes
    that join one gloo group on a file store; returns {rank: what fn
    returned}, which each child saves with ``torch.save``. A child that
    raises fails the test with its traceback."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), "store")
    procs = mp.start_processes(_entry, args=(fn, world, store, args), nprocs=world,
                               join=False, start_method="spawn")
    deadline = time.time() + timeout
    while not procs.join(timeout=1.0):
        if time.time() > deadline:
            for p in procs.processes:
                p.terminate()
            pytest.fail(f"{fn.__name__} did not finish in {timeout} s")
    return {r: torch.load(f"{store}.{r}.pt", weights_only=True) for r in range(world)}


def _entry(rank, fn, world, store, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, store, *args), f"{store}.{rank}.pt")
    finally:
        pmesh.destroy_distributed()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- one process


def test_make_mesh_one_process():
    """No group: 1 x 1 (or n_data=None) is None, anything else raises."""
    assert pmesh.world_size() == 1 and pmesh.rank() == 0 and pmesh.is_main()
    assert pmesh.make_mesh() is None and pmesh.make_mesh(1, 1) is None
    assert pmesh.mesh_shape(None, 2, 4) == (2, 2) and pmesh.mesh_shape(None, 1, 2) == (2, 1)
    for shape in ((2, 1), (1, 2), (3, 1)):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            pmesh.make_mesh(*shape)
    with pytest.raises(ValueError, match="needs 3 ranks"):
        pmesh.mesh_shape(3, 1, 2)
    with pytest.raises(ValueError, match="positive"):
        pmesh.mesh_shape(None, 0, 2)


def test_exercise_runs_on_the_card_unless_asked(monkeypatch):
    """Without ``device``, the exercise asks for CUDA and, where there is
    none, raises through ``get_device`` rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_step_on_mesh(1, 1, n_steps=1)


def test_mesh_flag_without_launcher_raises(tmp_path, monkeypatch):
    """``--n_data 2`` (or ``--n_model 2``) without the launcher raises
    before any work; the flags reach ``Config.mesh``."""
    from consistent__style_transfer_torch.config import config_from_args

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = config_from_args(["--n_data", "2", "--n_model", "3"])
    assert (cfg.mesh.n_data, cfg.mesh.n_model) == (2, 3)
    assert make_config("yelp").mesh.n_data is None and make_config("yelp").mesh.n_model == 1
    for flag in ("--n_data", "--n_model"):
        with pytest.raises(ValueError, match="one process"):
            cli.main(["pretrain", flag, "2", "--device", "cpu", "--dump_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    assert pmesh.init_distributed(make_config("yelp", device="cpu")) is False


def test_batch_rows_match_jax_shard_batch():
    """Data index i keeps the rows the JAX ``shard_batch`` puts on the
    devices of data index i; a batch the data size does not divide raises."""
    import jax

    from consistent__style_transfer_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from consistent__style_transfer_tpu.parallel.sharding import shard_batch as jax_shard_batch

    class Stub:  # the two methods of a DeviceMesh that the row split reads
        def __init__(self, D, i):
            self.D, self.i = D, i

        def size(self, dim):
            return self.D

        def get_local_rank(self, name):
            return self.i

    x = np.arange(8 * 3).reshape(8, 3).astype(np.int32)
    for D, M in ((2, 1), (4, 2), (2, 2)):
        jmesh = jax_make_mesh(D, M, devices=jax.devices()[:D * M])
        arr = jax_shard_batch({"x": x}, jmesh)["x"]
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for i in range(D):
            got = sharding.shard_batch({"x": x}, Stub(D, i))["x"]
            for dev in jmesh.devices[i]:
                np.testing.assert_array_equal(got, by_device[dev])
        stacked = sharding.shard_stacked_batch({"x": np.stack([x, x + 1])}, Stub(D, 1))["x"]
        np.testing.assert_array_equal(stacked, np.stack([x, x + 1])[:, 8 // D:2 * 8 // D])
    with pytest.raises(ValueError, match="does not split"):
        sharding.batch_sharding(Stub(3, 0), 8)
    assert sharding.shard_batch({"x": x}, None)["x"] is x


def _encode_jax_layout(params, shardings):
    """Each leaf replaced by the model index of the device that holds each
    element under the JAX sharding, -1 where it is replicated."""
    import jax

    def enc(leaf, sh):
        out = np.full(leaf.shape, -1.0, np.float32)
        for axis, name in enumerate(sh.spec):
            if name == "model":
                coords = np.arange(leaf.shape[axis]) // (leaf.shape[axis] // 2)
                shape = [1] * leaf.ndim
                shape[axis] = -1
                out = np.broadcast_to(coords.reshape(shape), leaf.shape).astype(np.float32)
        return out

    return jax.tree.map(enc, params, shardings)


def _encode_port_layout(module):
    class Stub:
        def size(self, dim):
            return 2

    out = {}
    for name, (pl,) in sharding.param_shardings(module, Stub()).items():
        shape = tuple(module.get_parameter(name).shape)
        enc = np.full(shape, -1.0, np.float32)
        if pl.is_shard():
            coords = np.arange(shape[pl.dim]) // (shape[pl.dim] // 2)
            view = [1] * len(shape)
            view[pl.dim] = -1
            enc = np.broadcast_to(coords.reshape(view), shape).astype(np.float32)
        out[name] = enc
    return out


def test_param_shardings_match_jax_rules():
    """The port's placements over ``model`` equal the JAX package's specs,
    element for element after the weight mapping, for the five modules of
    the optimize stage; exactly the names of the rule table are sharded."""
    import jax
    import jax.numpy as jnp

    from consistent__style_transfer_torch.utils import interop
    from consistent__style_transfer_tpu import models as jm
    from consistent__style_transfer_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from consistent__style_transfer_tpu.parallel.sharding import param_shardings as jax_rules

    jmesh = jax_make_mesh(1, 2, devices=jax.devices()[:2])
    x, lab = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    key = jax.random.PRNGKey(0)
    size = dict(d_model=32, n_heads=4, n_layers=2)
    cases = [
        (jm.TransformerLM(n_vocab=V, **size).init(key, x), interop.lm_state_dict_from_jax,
         TransformerLM(V, **size)),
        (jm.PairMatcher(n_vocab=V, **size).init(key, x, x), interop.matcher_state_dict_from_jax,
         PairMatcher(V, **size)),
        (jm.DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L).init(
            key, x, lab, None, lab, deterministic=True),
         interop.generator_state_dict_from_jax, DenoiseSeq2Seq(V, 2, L)),
        (jm.TextCNN(n_vocab=V).init(key, x), interop.classifier_state_dict_from_jax, TextCNN(V)),
        (jm.RelGANDiscriminator(n_vocab=V).init(key, x), interop.discriminator_state_dict_from_jax,
         RelGANDiscriminator(V)),
    ]
    n_sharded = 0
    for params, to_port, module in cases:
        want = to_port(_encode_jax_layout(params, jax_rules(params, jmesh)))
        got = _encode_port_layout(module)
        assert sorted(want) == sorted(got)
        for name, enc in got.items():
            np.testing.assert_array_equal(enc, want[name].numpy(), err_msg=name)
            sharded = (enc >= 0).any()
            assert sharded == name.endswith(SHARDED), name
            n_sharded += sharded
    assert n_sharded == 2 * 2 * 6 + 2 + 1  # 6 a layer, 2 layers, 2 towers; fwd; fn_2


# --------------------------------------------------------------- two ranks


def _two_rank_job(rank, world, store, tmp):
    """Everything the two-rank tests read, in one group."""
    from torch.distributed.tensor.experimental import implicit_replication

    out = {}
    dp = pmesh.make_mesh(None, 1, "cpu")
    tp = pmesh.make_mesh(1, 2, "cpu")
    out["dp"] = (tuple(dp.mesh.shape), dp.get_local_rank("data"), dp.get_local_rank("model"))
    out["tp"] = (tuple(tp.mesh.shape), tp.get_local_rank("data"), tp.get_local_rank("model"))
    out["cached"] = pmesh.make_mesh(2, 1, "cpu") is dp
    out["group_type"] = pmesh.make_mesh(2, 1) is dp and pmesh.make_mesh(1, 2).device_type
    for shape in ((2, 2), (1, 1), (3, None)):
        try:
            pmesh.make_mesh(shape[0], shape[1] or 1, "cpu")
            out[f"raised{shape}"] = False
        except ValueError:
            out[f"raised{shape}"] = True
    cfg = make_config("yelp", device="cpu")
    cfg.mesh.n_data = 3
    try:
        pmesh.init_distributed(cfg)
        out["init_raised"] = False
    except ValueError:
        out["init_raised"] = True

    lm = TransformerLM(V, d_model=32, n_heads=4, n_layers=2, p_drop=0.0).eval()
    x = torch.randint(0, V, (4, L), generator=torch.Generator().manual_seed(0))
    want = lm(x)
    sharding.shard_params(lm, tp)
    with implicit_replication():
        got = sharding.full_tensor(lm(x))
    out["lm_tp_diff"] = float((got - want).abs().max() / want.abs().max())

    try:
        cli.main(["serve", "--device", "cpu"])
        out["serve"] = None
    except RuntimeError as e:
        out["serve"] = str(e)

    out["ex_dp"] = optimize_step_on_mesh(2, 1, **EXERCISE)
    out["ex_tp"] = optimize_step_on_mesh(1, 2, ckpt_dir=os.path.join(tmp, "ckpt"), **EXERCISE)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    return run_ranks(_two_rank_job, 2, tmp, str(tmp))


def test_make_mesh_two_ranks(two_ranks):
    """(2, 1) and (1, 2) over two ranks, rank r at data index r // M and
    model index r % M, as the JAX package reshapes its device list; a mesh
    the world cannot make raises, and so does a launch asking for one."""
    import jax

    from consistent__style_transfer_tpu.parallel.mesh import make_mesh as jax_make_mesh

    for shape, key in (((2, 1), "dp"), ((1, 2), "tp")):
        jmesh = jax_make_mesh(*shape, devices=jax.devices()[:2])
        for r in (0, 1):
            coords = tuple(int(c[0]) for c in np.nonzero(
                np.vectorize(lambda d: d.id)(jmesh.devices) == jax.devices()[r].id))
            assert two_ranks[r][key] == (shape, *coords), (key, r)
    for r in (0, 1):
        res = two_ranks[r]
        assert res["cached"] and res["init_raised"] and res["group_type"] == "cpu"
        assert res["raised(2, 2)"] and res["raised(1, 1)"] and res["raised(3, None)"]


def test_tp_forward_equals_replicated(two_ranks):
    for r in (0, 1):
        assert two_ranks[r]["lm_tp_diff"] < 1e-5


def test_serve_raises_under_two_ranks(two_ranks):
    for r in (0, 1):
        assert "one process" in two_ranks[r]["serve"]


@pytest.fixture(scope="module")
def one_process_exercise():
    return optimize_step_on_mesh(1, 1, **EXERCISE)


def test_exercise_dp_and_tp_equal_one_process(two_ranks, one_process_exercise):
    """(2, 1) and (1, 2) against (1, 1): every step's G and D losses and the
    validation within rel 1e-5, on both ranks; D applied at step 0."""
    ref = one_process_exercise
    assert ref["mesh"] == {"data": 1, "model": 1} and not ref["dist"] and ref["n_steps"] == 2
    for key, mesh in (("ex_dp", {"data": 2, "model": 1}), ("ex_tp", {"data": 1, "model": 2})):
        for r in (0, 1):
            got = two_ranks[r][key]
            assert got["mesh"] == mesh and got["dist"]
            for (g, d), (wg, wd) in zip(got["losses"], ref["losses"]):
                assert g == pytest.approx(wg, rel=REL) and d == pytest.approx(wd, rel=REL)
            assert got["val"] == pytest.approx(ref["val"], rel=REL)
            assert all(np.isfinite(v) for v in (got["g_loss"], got["d_loss"], got["val"]))


@pytest.fixture(scope="module")
def one_process_three_steps():
    return optimize_step_on_mesh(1, 1, **{**EXERCISE, "n_steps": 3})


def test_exercise_clip_and_moments_equal_one_process(two_ranks, one_process_exercise,
                                                     one_process_three_steps):
    """At (2, 1) and (1, 2), for every parameter of G and D, the norms of
    its clipped gradient and of both Adam moments equal (1, 1)'s within
    rel 1e-5 on both ranks (abs 1e-5 of the optimizer's largest norm of
    that kind, as the DP tests bound a tensor by its largest entry: under
    TP the sharded sums round differently, and second moments near 0 move
    by up to 3e-5 of themselves). The global norm is above ``clip``, so the
    clip takes effect: the whole clipped gradient has norm ``clip``. A norm
    that missed the other ranks' shards, or a sharded gradient off by a
    factor, moves these numbers; the losses after a few small Adam steps
    do not. The (1, 2) run goes on one step after its restore, so it is
    held against three steps."""
    clip = EXERCISE["clip"]
    for key, ref in (("ex_dp", one_process_exercise), ("ex_tp", one_process_three_steps)):
        want = ref["moments"]
        for opt in ("g", "d"):
            norm = np.sqrt(sum(v * v for k, v in want.items()
                               if k.startswith(f"{opt}/") and k.endswith("/grad")))
            assert norm == pytest.approx(clip, rel=REL), (opt, norm)
        for r in (0, 1):
            got = two_ranks[r][key]["moments"]
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                opt, _, kind = k.split("/")
                floor = REL * max(v for kk, v in want.items()
                                  if kk.startswith(f"{opt}/") and kk.endswith(f"/{kind}"))
                assert got[k] == pytest.approx(w, rel=REL, abs=floor), (key, r, k, got[k], w)


def test_exercise_tp_shards_the_rule_table(two_ranks):
    """At (1, 2) the named parameters of G and the two transformer towers
    are ``Shard``ed, every other parameter of theirs replicated, and the
    classifier and D keep plain parameters."""
    placements = two_ranks[0]["ex_tp"]["placements"]
    assert placements and not two_ranks[0]["ex_dp"]["placements"]
    for name, pls in placements.items():
        assert pls == (["S(0)"] if name.endswith(("in_proj_weight", "in_proj_bias",
                                                  "linear1.weight", "linear1.bias", "fwd.weight",
                                                  "fwd.bias", "fn_2.weight"))
                       else ["S(1)"] if name.endswith(("out_proj.weight", "linear2.weight"))
                       else ["R"]), name
    assert {"fn_2.weight", "fwd.weight", "fwd.bias"} <= set(placements)
    assert not [n for n in placements if n.startswith(("convs.", "embeddings", "highway"))]


def test_exercise_checkpoint_round_trip_continues(two_ranks, one_process_three_steps,
                                                  tmp_path):
    """At (1, 2) the full state is saved whole, restored equal to the live
    parameters, laid out again and trained one more step, which equals the
    third step of a (1, 1) run."""
    got = two_ranks[0]["ex_tp"]
    assert got["ckpt_roundtrip"] and got["n_steps"] == 3
    ref3 = one_process_three_steps
    for (g, d), (wg, wd) in zip(got["losses"], ref3["losses"]):
        assert g == pytest.approx(wg, rel=REL) and d == pytest.approx(wd, rel=REL)
    one = optimize_step_on_mesh(1, 1, ckpt_dir=str(tmp_path / "ck"), **EXERCISE)
    assert one["n_steps"] == 3 and one["losses"] == pytest.approx(ref3["losses"], rel=REL)
    assert os.listdir(tmp_path / "ck") == ["state_2.pt"]
