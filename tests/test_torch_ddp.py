"""ddp_tpu_torch's SimpleCNN and data-parallel step ≡ the JAX package's.

Shared weights (the port's seeded numpy init, carried into the JAX tree
by ``cnn_params_to_jax``) and the same uint8 batches go through
``ddp_tpu.parallel.ddp`` on a 1- or 2-device mesh of emulated CPU
devices and through the port's step on the CPU. A port world of 2 runs
in-process: one thread per rank, each with its own replica, summing the
gradient bucket over both (``runtime/dist.ThreadWorld``), as the mesh's
pmean does over its two devices. Compared: loss, accuracy and grad norm
per step, parameters leaf by leaf after the last step.

Tolerances, fp32: metrics rtol 1e-5, parameters atol 2e-5 (the
frameworks sum in different orders). bf16 compute: metrics rtol 2e-2,
parameters atol 1e-3 (bf16 rounds at other places in the two
frameworks). Logits on shared weights at full width: atol 1e-4.
Schedules: rtol 1e-6 (float32 cos of numpy against XLA's).
"""

import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.data import sampler as jsampler
from ddp_tpu.interop.torch_checkpoint import params_to_torch_state_dict
from ddp_tpu.models.cnn import SimpleCNN as JaxCNN
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train import fast as jfast
from ddp_tpu.train.optim import lr_at as jax_lr_at
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu.train.optim import make_schedule as jax_make_schedule
from ddp_tpu_torch.interop.jax_params import (
    cnn_params_from_jax,
    cnn_params_to_jax,
    flatten_tree,
)
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.parallel.ddp import TrainState, make_eval_step, make_train_step
from ddp_tpu_torch.runtime import dist as tdist
from ddp_tpu_torch.train import fast as tfast
from ddp_tpu_torch.train import trainer as ttrainer
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import lr_at, make_optimizer, make_schedule

RTOL, ATOL = 1e-5, 2e-5
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
SMALL = (4, 8)
B = 8
REPO = Path(__file__).resolve().parent.parent


def identity(t):
    return t


def _batches(n, batch=B, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, 28, 28, 1), dtype=np.uint8),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _jax_state(tree, tx, mesh):
    state = jddp.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                            opt_state=tx.init(tree), model_state={})
    return jddp.replicate_state(state, mesh)


def _mesh(world):
    return make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])


def _port_state(opt_kw, seed=0):
    model = SimpleCNN.from_state(init_cnn_state(SMALL, seed=seed), "cpu")
    return TrainState(0, model, make_optimizer(model.parameters(), **opt_kw))


def _assert_params_close(model, jtree, atol):
    got = flatten_tree(cnn_params_to_jax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jtree))
    assert sorted(got) == sorted(want)
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= atol, (k, err)


# ---- SimpleCNN -----------------------------------------------------------

def test_full_width_param_count():
    model = SimpleCNN()
    assert sum(p.numel() for p in model.parameters()) == 520_586
    assert sorted(model.state_dict()) == [
        "fl.bias", "fl.weight", "net.0.bias", "net.0.weight", "net.2.bias",
        "net.2.weight"]


def test_full_width_logits_equal_jax_on_converted_weights():
    tree = cnn_params_to_jax(init_cnn_state(seed=3))
    # Non-zero biases, so the flatten order of the head shows in every term.
    rng = np.random.default_rng(4)
    for leaf in ("conv1", "conv2", "fc"):
        tree[leaf]["bias"] = rng.standard_normal(tree[leaf]["bias"].shape,
                                                 dtype=np.float32)
    x = np.random.default_rng(5).integers(0, 256, (4, 28, 28, 1), dtype=np.uint8)
    want = np.asarray(JaxCNN().apply({"params": tree}, jnp.asarray(x) / 255.0))
    model = SimpleCNN.from_state(cnn_params_from_jax(tree), "cpu")
    xt = torch.from_numpy(x).float().div(255.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt).numpy()
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # A converter that ignored the flatten order would compute another
    # function on the same parameter multiset: the same check fails.
    wrong = cnn_params_from_jax(tree)
    wrong["fl.weight"] = tree["fc"]["kernel"].T.copy()
    with torch.no_grad():
        bad = SimpleCNN.from_state(wrong, "cpu")(xt).numpy()
    assert np.abs(bad - want).max() > 1e-2


def test_state_dict_equals_jax_torch_checkpoint_export():
    tree = cnn_params_to_jax(init_cnn_state(SMALL, seed=1))
    want = params_to_torch_state_dict(tree)
    got = SimpleCNN.from_state(cnn_params_from_jax(tree), "cpu").state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_params_to_jax_inverts_from_jax():
    state = init_cnn_state(SMALL, seed=2)
    back = cnn_params_from_jax(cnn_params_to_jax(state))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    tree = cnn_params_to_jax(state)
    again = flatten_tree(cnn_params_to_jax(cnn_params_from_jax(tree)))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(again[k], v)


# ---- the data-parallel train step ----------------------------------------

CASES = {
    "sgd": (dict(name="sgd", lr=0.05), {}),
    "momentum": (dict(name="sgd", lr=0.05, momentum=0.9), {}),
    "adam": (dict(name="adam", lr=3e-3), {}),
    "accum2": (dict(name="sgd", lr=0.05, momentum=0.9),
               dict(grad_accum_steps=2)),
    "smoothing": (dict(name="sgd", lr=0.05), dict(label_smoothing=0.1)),
    "bf16": (dict(name="sgd", lr=0.05), dict(bf16=True)),
}


def _run_jax(opt_kw, step_kw, world, batches):
    tree = cnn_params_to_jax(init_cnn_state(SMALL, seed=0))
    tx = jax_make_optimizer(**opt_kw)
    mesh = _mesh(world)
    state = _jax_state(tree, tx, mesh)
    step = jddp.make_train_step(
        JaxCNN(features=SMALL), tx, mesh, donate=False,
        compute_dtype=jnp.bfloat16 if step_kw.get("bf16") else jnp.float32,
        grad_accum_steps=step_kw.get("grad_accum_steps", 1),
        label_smoothing=step_kw.get("label_smoothing", 0.0),
    )
    rows = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        rows.append((float(m.loss), float(m.accuracy), float(m.grad_norm)))
    return state, rows


def _run_port(opt_kw, step_kw, world, batches):
    """Every rank's replica steps on its contiguous rows of each batch
    (the mesh's data sharding) → (replicas, per-step metrics of rank 0)."""
    tw = tdist.ThreadWorld(world)
    kw = dict(world=world,
              compute_dtype=torch.bfloat16 if step_kw.get("bf16") else torch.float32,
              grad_accum_steps=step_kw.get("grad_accum_steps", 1),
              label_smoothing=step_kw.get("label_smoothing", 0.0))

    def rank_body(rank):
        state = _port_state(opt_kw)
        step = make_train_step(state, reduce=tw.reduce(rank), **kw)
        local = B // world
        rows = []
        for x, y in batches:
            sl = slice(rank * local, (rank + 1) * local)
            m = step(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]))
            rows.append((float(m.loss), float(m.accuracy), float(m.grad_norm)))
        assert state.step == len(batches)
        return state, rows

    return tw.run(rank_body)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, world):
    opt_kw, step_kw = CASES[case]
    batches = _batches(3)
    jstate, jrows = _run_jax(opt_kw, step_kw, world, batches)
    ranks = _run_port(opt_kw, step_kw, world, batches)
    rtol, atol = (BF16_RTOL, BF16_ATOL) if step_kw.get("bf16") else (RTOL, ATOL)
    for state, rows in ranks:
        np.testing.assert_allclose(np.array(rows), np.array(jrows), rtol=rtol)
        _assert_params_close(state.model, jstate.params, atol)
    # Replicas stay bit-identical: every rank applies the same bucket.
    for p0, p1 in zip(ranks[0][0].model.parameters(),
                      ranks[-1][0].model.parameters()):
        assert torch.equal(p0, p1)


def test_world_2_step_divides_by_the_world():
    """Negative control of the world-2 check: a bucket divided by the
    world once more (the mistake the on-card check also plants) gives
    other parameters than JAX's pmean step."""
    opt_kw, step_kw = CASES["sgd"]
    batches = _batches(1)
    jstate, _ = _run_jax(opt_kw, step_kw, 2, batches)
    tw = tdist.ThreadWorld(2)

    def body(rank):
        state = _port_state(opt_kw)
        inner = tw.reduce(rank)
        step = make_train_step(state, world=2,
                               reduce=lambda t: inner(t).div_(2))
        x, y = batches[0]
        step(torch.from_numpy(x[rank * 4:(rank + 1) * 4]),
             torch.from_numpy(y[rank * 4:(rank + 1) * 4]))
        return state

    state = tw.run(body)[0]
    with pytest.raises(AssertionError):
        _assert_params_close(state.model, jstate.params, ATOL)


@pytest.mark.parametrize("n", [13, 16])
def test_eval_step_matches_jax_weighted_counts(n):
    """A split of 13 (not a multiple of the batch of 4) padded by wrap,
    the padding weighted 0: the weighted correct and loss sums equal
    JAX's make_eval_step's, in fp32 and bf16."""
    tree = cnn_params_to_jax(init_cnn_state(SMALL, seed=6))
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
    y = rng.integers(0, 10, n).astype(np.int32)
    bs = 4
    padded = -(-n // bs) * bs
    w = (np.arange(padded) < n).astype(np.float32)
    idx = np.arange(padded) % n
    mesh = _mesh(1)
    model = SimpleCNN.from_state(cnn_params_from_jax(tree), "cpu")
    for jdt, tdt, rtol in ((jnp.float32, torch.float32, RTOL),
                           (jnp.bfloat16, torch.bfloat16, BF16_RTOL)):
        jstep = jddp.make_eval_step(JaxCNN(features=SMALL), mesh,
                                    compute_dtype=jdt)
        tstep = make_eval_step(model, reduce=identity, compute_dtype=tdt)
        jtot, ttot = np.zeros(2), np.zeros(2)
        for b in range(padded // bs):
            s = slice(b * bs, (b + 1) * bs)
            c, l = jstep(tree, {}, jnp.asarray(x[idx[s]]), jnp.asarray(y[idx[s]]),
                         jnp.asarray(w[s]))
            jtot += [float(c), float(l)]
            c, l = tstep(torch.from_numpy(x[idx[s]]), torch.from_numpy(y[idx[s]]),
                         torch.from_numpy(w[s]))
            ttot += [float(c), float(l)]
        assert ttot[0] == jtot[0]
        np.testing.assert_allclose(ttot[1], jtot[1], rtol=rtol)


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=5, decay_steps=40),
    dict(decay_steps=30),
    dict(warmup_steps=4, lr_milestones=(3, 10, 20)),
    dict(lr_milestones=(5, 12), lr_decay_factor=0.5),
    dict(warmup_steps=6),
    {},
], ids=["warmup_cosine", "cosine", "milestones_warmup", "milestones",
        "warmup", "constant"])
def test_lr_at_matches_jax_schedule(kw):
    js, ts = jax_make_schedule(0.1, **kw), make_schedule(0.1, **kw)
    got = [lr_at(ts, s) for s in range(50)]
    want = [jax_lr_at(js, s) for s in range(50)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        make_schedule(0.1, decay_steps=10, lr_milestones=(3,))
    with pytest.raises(ValueError):
        make_schedule(0.1, lr_milestones=(9, 3))


def test_scheduled_sgd_steps_match_jax():
    """The optimizer reads the schedule at update k (from 0), as optax's
    count does: three steps under warmup + cosine."""
    opt = dict(name="sgd", lr=0.1, momentum=0.9, warmup_steps=2, decay_steps=5)
    jstate, jrows = _run_jax(opt, {}, 1, _batches(3))
    sched = make_schedule(0.1, warmup_steps=2, decay_steps=5)
    (state, rows), = _run_port(dict(name="sgd", lr=sched, momentum=0.9), {}, 1,
                               _batches(3))
    np.testing.assert_allclose(np.array(rows), np.array(jrows), rtol=RTOL)
    _assert_params_close(state.model, jstate.params, ATOL)


# ---- the epoch runner ------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2])
def test_epoch_runner_fed_jax_plan_matches_jax_runner(world):
    """Rank r's stripe of each global batch (rows [b·G + r·local, …) of
    the permutation) against ``make_epoch_runner`` on a ``world``-device
    mesh, over two epochs of 5 steps (the 43rd..: tail dropped)."""
    n, G, seed = 43, 8, 2
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    tree = cnn_params_to_jax(init_cnn_state(SMALL, seed=0))
    opt_kw = dict(name="sgd", lr=0.05, momentum=0.9)
    tx = jax_make_optimizer(**opt_kw)
    mesh = _mesh(world)
    jimg, jlbl = jfast.device_put_dataset(images, labels, mesh)
    jrun = jfast.make_epoch_runner(JaxCNN(features=SMALL), tx, mesh, jimg, jlbl,
                                   G, seed=seed, donate=False)
    jstate = _jax_state(tree, tx, mesh)
    jloss = []
    for epoch in (0, 1):
        jstate, jm = jrun(jstate, epoch)
        jloss.append(np.asarray(jm.loss))
    plan = jsampler.ShardSampler(n, 1, 0, seed=seed).epoch_indices
    tw = tdist.ThreadWorld(world)

    def rank_body(rank):
        state = _port_state(opt_kw)
        run = tfast.make_epoch_runner(
            state, torch.from_numpy(images), torch.from_numpy(labels), G,
            rank=rank, world=world, reduce=tw.reduce(rank), permutation=plan)
        assert run.steps_per_epoch == jrun.steps_per_epoch == 5
        losses = [run(epoch).loss.numpy() for epoch in (0, 1)]
        assert len(run.step_seconds()) == 5
        return state, losses

    for state, losses in tw.run(rank_body):
        np.testing.assert_allclose(np.concatenate(losses),
                                   np.concatenate(jloss), rtol=RTOL)
        assert state.step == 10
        _assert_params_close(state.model, jstate.params, ATOL)


# ---- the process group and the ranks ---------------------------------------

def test_dist_setup_backend_rules():
    """nccl needs a card; the default device is the GPU; a world of 1
    comes up over gloo on the CPU and reduces through the group."""
    with pytest.raises(ValueError, match="nccl"):
        tdist.setup(backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.setup()
    ctx = tdist.setup(device="cpu")
    try:
        assert (ctx.backend, ctx.process_id, ctx.num_processes) == ("gloo", 0, 1)
        assert ctx.is_main and tdist.current() is ctx
        with pytest.raises(RuntimeError, match="already"):
            tdist.setup(device="cpu")
        t = torch.arange(3.0)
        assert torch.equal(tdist.all_reduce_sum(t), torch.arange(3.0))
        tdist.sync_global_devices("test")
    finally:
        tdist.cleanup()
    tdist.cleanup()  # idempotent


def test_spawn_refuses_more_nccl_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(ttrainer, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    config = TrainConfig.from_args(["--spawn", "2"])
    with pytest.raises(ValueError, match="one rank on each card"):
        ttrainer.spawn(config, ["--spawn", "2"])


def test_spawn_2_over_gloo_equals_world_1(tmp_path):
    """A real ``--spawn 2`` gloo run on the CPU (per-rank batch 16) and a
    world-1 run at batch 32: each step's union of the two strided shards
    is the world-1 batch, so the parameters after one epoch agree to
    fp32 summation order (atol 1e-6)."""
    base = ["-m", "ddp_tpu_torch.train", "--device", "cpu", "--synthetic_data",
            "--synthetic_size", "256", "--epochs", "1", "--log_interval", "4"]
    t0 = time.perf_counter()
    two = subprocess.run(
        [sys.executable, *base, "--spawn", "2", "--batch_size", "16",
         "--checkpoint_dir", str(tmp_path / "w2")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    seconds = time.perf_counter() - t0
    one = subprocess.run(
        [sys.executable, *base, "--batch_size", "32",
         "--checkpoint_dir", str(tmp_path / "w1")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    evals = []
    for res in (one, two):
        lines = res.stdout.strip().splitlines()
        assert lines[-1].startswith("final_accuracy=")
        assert sum(" done: 8 batches" in line for line in lines) == 1
        evals.append([line for line in lines if " eval: " in line])
    # The test split's weighted sums over two ranks: the same 4 decimals.
    assert evals[0] == evals[1] and len(evals[0]) == 1
    a = torch.load(tmp_path / "w1/epoch_0/state.pt", weights_only=True)
    b = torch.load(tmp_path / "w2/epoch_0/state.pt", weights_only=True)
    assert a["step"] == b["step"] == 8
    for k in a["params"]:
        torch.testing.assert_close(b["params"][k], a["params"][k], atol=1e-6,
                                   rtol=0)
    print(f"spawn-2 run: {seconds:.1f} s")
