"""The port's block-sparse FFN training step (spgemm_tpu_torch/models/ffn.py:
make_sharded_train_step, shard_params; parallel/mesh.train_mesh; the
gelu_grad epilogue of ops/cuda_bsmm.py and kernel 5's plain version in
ops/cuda_bsmm_grad.py) against the JAX package (spgemm_tpu/models/ffn.py), on
the CPU.  Inputs come from a numpy seed, the weights from the JAX
init_params through params_from_jax; meshes wider than 1 x 1 run as gloo
ranks, one subprocess each (tests/_ffn_train_worker.py), at most 4.

The oracle of the step is JAX's single-device gradient, jax.value_and_grad
of loss_fn on the whole batch, then SGD.  JAX's own sharded step agrees
with it where tp = 1 and multiplies every weight gradient by tp elsewhere
(check_vma=False makes the transpose of its psum over tp a psum): a fault of
the reference, shown here at tp = 2; the port does not copy it.

Tolerances, all float32, at a config of d_model 64, d_ff 256, k 8, density
0.5, x (4, 8, 64), lr 1 (so that an update shows the whole gradient):
  * the loss, rtol 1e-5: the same squares summed in another order;
  * the updated tiles, atol 1e-6 with rtol 1e-5: both sides sum each
    gradient element over 32 rows and up to 4 tiles in float32 in another
    order, about 1e-8 apart against gradients of at most ~0.05 and tiles
    of at most ~1; the margin covers the second step's drift;
  * a gradient read back from one update, (p0 - p1) / lr, at rtol 1e-4 and
    atol 1e-6: the subtraction cancels about 1e-7 of each tile;
  * the plain gradients (bsmm_wgrad_ref, bsmm_ref with gelu_grad) against
    autograd and jax.vjp, rtol = atol = 1e-5: the same products summed in
    another order."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spgemm_tpu.models import ffn as jffn
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.ops import cuda_bsmm, cuda_bsmm_grad
from spgemm_tpu_torch.parallel.mesh import TrainMesh, train_mesh
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_ffn_train_worker.py")
CFG = dict(d_model=64, d_ff=256, k=8, block_density=0.5, dtype="float32")
SHAPE = (4, 8)       # (batch, seq): splits over dp 2 and tp 2
LR = 1.0
STEPS = 2
BLOCK_M = 16         # M = 32 rows: two blocks
LOSS_RTOL = 1e-5
TILE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed: int = 7):
    """(jax cfg, jax params, numpy params, x, y): the config of the issue's
    check, weights from the JAX init, data from numpy."""
    jcfg = jffn.BlockSparseFFNConfig(**CFG)
    jp = jffn.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((*SHAPE, jcfg.d_model)).astype(np.float32)
    y = rng.standard_normal((*SHAPE, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, jax.tree.map(np.asarray, jp), x, y


def _jax_true_steps(jp, x, y, jcfg, steps: int = STEPS):
    """JAX's single-device oracle: value_and_grad of loss_fn on the whole
    batch, then p - lr * g, `steps` times; (losses, [(w1, w2) after each])."""
    tiles = {"w1": jp["w1"]["tiles"], "w2": jp["w2"]["tiles"]}

    def loss_of(t):
        return jffn.loss_fn({"w1": {"rows": jp["w1"]["rows"], "tiles": t["w1"]},
                             "w2": {"cols": jp["w2"]["cols"], "tiles": t["w2"]}},
                            jnp.asarray(x), jnp.asarray(y), jcfg)

    losses, after = [], []
    for _ in range(steps):
        loss, g = jax.value_and_grad(loss_of)(tiles)
        tiles = jax.tree.map(lambda p, d: p - LR * d, tiles, g)
        losses.append(float(loss))
        after.append((np.asarray(tiles["w1"]), np.asarray(tiles["w2"])))
    return losses, after


def _jax_sharded_steps(jp, x, y, jcfg, dp: int, tp: int, steps: int = STEPS):
    """JAX's own sharded step on dp * tp of the 8 host devices."""
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))
    step = jffn.make_sharded_train_step(mesh, jcfg, lr=LR)
    params = jffn.shard_params(jp, mesh)
    data = NamedSharding(mesh, P("dp", "tp"))
    xs, ys = jax.device_put(jnp.asarray(x), data), jax.device_put(jnp.asarray(y), data)
    losses, after = [], []
    for _ in range(steps):
        params, loss = step(params, xs, ys)
        losses.append(float(loss))
        after.append((np.asarray(params["w1"]["tiles"]), np.asarray(params["w2"]["tiles"])))
    return losses, after


def _port_local(np_params, x, y, tcfg, steps: int = STEPS, block_m: int = BLOCK_M):
    """The port's step at 1 x 1 in this process."""
    mesh = train_mesh(device="cpu")
    params = ffn.shard_params(ffn.params_from_jax(np_params, device="cpu"), mesh)
    step = ffn.make_sharded_train_step(mesh, tcfg, lr=LR, block_m=block_m)
    xs, ys = ffn.shard_data(torch.from_numpy(x), mesh), ffn.shard_data(torch.from_numpy(y), mesh)
    losses, after = [], []
    for _ in range(steps):
        params, loss = step(params, xs, ys)
        losses.append(float(loss))
        after.append((params["w1"]["tiles"].numpy(), params["w2"]["tiles"].numpy()))
    return losses, after


def _port_ranks(np_params, x, y, jcfg, dp: int, tp: int, workdir: str):
    """The port's step at (dp, tp) as dp * tp gloo ranks; each rank's losses
    must agree, and every dp rank must hold the same tp shards.  Returns
    (losses, [(w1, w2) after each step]) with the shards put together."""
    np.savez(os.path.join(workdir, "inputs.npz"), x=x, y=y, lr=LR, steps=STEPS,
             block_m=BLOCK_M, density=jcfg.block_density,
             cfg_ints=np.array([jcfg.d_model, jcfg.d_ff, jcfg.k]),
             w1_rows=np_params["w1"]["rows"], w1_tiles=np_params["w1"]["tiles"],
             w2_cols=np_params["w2"]["cols"], w2_tiles=np_params["w2"]["tiles"])
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, workdir, str(r), str(dp), str(tp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(dp * tp)]
    try:
        logs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of ({dp}, {tp}):\n{err}"
    outs = [np.load(os.path.join(workdir, f"out_{r}.npz")) for r in range(dp * tp)]
    for o in outs:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    shards = {}
    for o in outs:
        d, t = map(int, o["coords"])
        if t in shards:
            np.testing.assert_array_equal(o["w1"], shards[t]["w1"])
            np.testing.assert_array_equal(o["w2"], shards[t]["w2"])
        shards[t] = o
    after = [(np.concatenate([shards[t]["w1"][s] for t in range(tp)]),
              np.concatenate([shards[t]["w2"][s] for t in range(tp)])) for s in range(STEPS)]
    return list(outs[0]["losses"]), after


_PORT_RUNS: dict = {}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's run at a mesh, once per module (one spawn per mesh)."""
    jcfg, _, np_params, x, y = _inputs()

    def run(dp: int, tp: int):
        if (dp, tp) not in _PORT_RUNS:
            if dp * tp == 1:
                _PORT_RUNS[1, 1] = _port_local(np_params, x, y, ffn.BlockSparseFFNConfig(**CFG))
            else:
                workdir = str(tmp_path_factory.mktemp(f"ffn_train_{dp}x{tp}"))
                _PORT_RUNS[dp, tp] = _port_ranks(np_params, x, y, jcfg, dp, tp, workdir)
        return _PORT_RUNS[dp, tp]

    return run


def _same_run(got, want, tile_tol=TILE_TOL):
    (g_losses, g_after), (w_losses, w_after) = got, want
    np.testing.assert_allclose(g_losses, w_losses, rtol=LOSS_RTOL)
    for (g1, g2), (w1, w2) in zip(g_after, w_after):
        np.testing.assert_allclose(g1, w1, **tile_tol)
        np.testing.assert_allclose(g2, w2, **tile_tol)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_step_follows_the_single_device_gradient(port_run, dp, tp):
    jcfg, jp, _, x, y = _inputs()
    _same_run(port_run(dp, tp), _jax_true_steps(jp, x, y, jcfg))


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1)])
def test_sharded_step_matches_the_jax_step_where_tp_is_one(port_run, dp, tp):
    jcfg, jp, _, x, y = _inputs()
    _same_run(port_run(dp, tp), _jax_sharded_steps(jp, x, y, jcfg, dp, tp))


def test_the_jax_step_scales_the_gradient_by_tp_and_the_port_does_not(port_run):
    """The reference's fault at (dp, tp) = (1, 2): one update of JAX's
    sharded step reads back as 2 x the true gradient, the port's as 1 x.
    The loss agrees."""
    jcfg, jp, np_params, x, y = _inputs()
    true_losses, true_after = _jax_true_steps(jp, x, y, jcfg, steps=1)
    jax_losses, jax_after = _jax_sharded_steps(jp, x, y, jcfg, 1, 2, steps=1)
    port_losses, port_after = port_run(1, 2)
    np.testing.assert_allclose(jax_losses[0], true_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_losses[0], true_losses[0], rtol=LOSS_RTOL)
    for i, name in enumerate(("w1", "w2")):
        p0 = np_params[name]["tiles"]
        true = (p0 - true_after[0][i]) / LR
        assert np.abs(true).max() > 1e-3  # a gradient that shows
        np.testing.assert_allclose((p0 - jax_after[0][i]) / LR, 2 * true, **GRAD_TOL)
        port = (p0 - port_after[0][i]) / LR
        np.testing.assert_allclose(port, true, **GRAD_TOL)
        assert not np.allclose(port, 2 * true, **GRAD_TOL)


@pytest.mark.parametrize("block_m,resident", [(8, None), (16, False), (16, True), (128, None)])
def test_kernel_path_gradient_matches_the_plain_autograd_one(block_m, resident):
    """The step's kernel path (on the CPU its wrappers run the plain
    versions) against loss_and_grads_ref, at an M that block_m pads."""
    tcfg = ffn.BlockSparseFFNConfig(**CFG)
    _, _, np_params, _, _ = _inputs(11)
    params = ffn.params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((3, 5, tcfg.d_model)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((3, 5, tcfg.d_model)).astype(np.float32))
    step = ffn.make_sharded_train_step(train_mesh(device="cpu"), tcfg, lr=LR, block_m=block_m,
                                       resident=resident)
    before = ENGINE.counter_snapshot()
    loss, grads = step.loss_and_grads(params, x, y)
    after = ENGINE.counter_snapshot()
    for name in ("launches_bsmm", "launches_bsmm_resident", "launches_bsmm_wgrad"):
        assert after.get(name, 0) == before.get(name, 0)  # no kernel on the CPU
    want_loss, want = ffn.loss_and_grads_ref(params, x, y, tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name in ("w1", "w2"):
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(), **PLAIN_TOL)
    new, loss2 = step(params, x, y)
    ref_new, _ = ffn.train_step_ref(params, x, y, tcfg, lr=LR)
    assert new["w1"]["rows"] is params["w1"]["rows"] and new["w2"]["cols"] is params["w2"]["cols"]
    assert step.index(new) is step.index(params)  # the bookkeeping is kept across steps
    for name in ("w1", "w2"):
        np.testing.assert_allclose(new[name]["tiles"].numpy(), ref_new[name]["tiles"].numpy(),
                                   **TILE_TOL)


def _plain_layers(seed: int):
    """Small float32 operands of both matmuls: x (M, d_model), the port's
    params, a random dy (M, d_model) and the JAX params."""
    tcfg = ffn.BlockSparseFFNConfig(**CFG)
    jcfg, jp, np_params, _, _ = _inputs(seed)
    rng = np.random.default_rng(seed)
    M = 24
    x = rng.standard_normal((M, tcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((M, tcfg.d_model)).astype(np.float32)
    return tcfg, jcfg, jp, ffn.params_from_jax(np_params, device="cpu"), x, dy


def test_wgrad_ref_is_autograd_and_jax_vjp_of_the_plain_matmuls():
    tcfg, jcfg, jp, params, x, dy = _plain_layers(21)
    M, k = x.shape[0], tcfg.k
    index = ffn.step_index(params["w1"]["rows"], params["w2"]["cols"], tcfg.nb_model)
    rng = np.random.default_rng(22)
    dpre = rng.standard_normal((M, tcfg.d_ff)).astype(np.float32)
    h = rng.standard_normal((M, tcfg.d_ff)).astype(np.float32)
    # dW1 of pre = bsmm_gather(x, W1) against the cotangent dpre
    w1 = params["w1"]["tiles"].clone().requires_grad_()
    pre = ffn.bsmm_gather(torch.from_numpy(x).reshape(M, tcfg.nb_model, k),
                          {"rows": params["w1"]["rows"], "tiles": w1})
    (want1,) = torch.autograd.grad(pre, w1, torch.from_numpy(dpre).reshape(pre.shape))
    got1 = cuda_bsmm_grad.bsmm_wgrad_ref(torch.from_numpy(x), torch.from_numpy(dpre),
                                         index.ia1, index.ib1, k=k).reshape(w1.shape)
    np.testing.assert_allclose(got1.numpy(), want1.numpy(), **PLAIN_TOL)
    _, vjp1 = jax.vjp(lambda t: jffn.bsmm_gather(
        jnp.asarray(x).reshape(M, jcfg.nb_model, k), {"rows": jp["w1"]["rows"], "tiles": t}),
        jp["w1"]["tiles"])
    np.testing.assert_allclose(got1.numpy(), np.asarray(
        vjp1(jnp.asarray(dpre).reshape(M, jcfg.nb_ff, k))[0]), **PLAIN_TOL)
    # dW2 of y = bsmm_scatter(h, W2) against the cotangent dy
    w2 = params["w2"]["tiles"].clone().requires_grad_()
    y = ffn.bsmm_scatter(torch.from_numpy(h).reshape(M, tcfg.nb_ff, k),
                         {"cols": params["w2"]["cols"], "tiles": w2}, tcfg.nb_model)
    (want2,) = torch.autograd.grad(y, w2, torch.from_numpy(dy).reshape(y.shape))
    got2 = cuda_bsmm_grad.bsmm_wgrad_ref(torch.from_numpy(h), torch.from_numpy(dy),
                                         index.ia2, index.ib2, k=k).reshape(w2.shape)
    np.testing.assert_allclose(got2.numpy(), want2.numpy(), **PLAIN_TOL)
    _, vjp2 = jax.vjp(lambda t: jffn.bsmm_scatter(
        jnp.asarray(h).reshape(M, jcfg.nb_ff, k), {"cols": jp["w2"]["cols"], "tiles": t},
        jcfg.nb_model), jp["w2"]["tiles"])
    np.testing.assert_allclose(got2.numpy(), np.asarray(
        vjp2(jnp.asarray(dy).reshape(M, jcfg.nb_model, k))[0]), **PLAIN_TOL)


@pytest.mark.parametrize("M", [1, 17, 64, 0])
def test_wgrad_ref_at_any_M(M):
    """Any M, a ragged one included, and none (a zero gradient)."""
    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.standard_normal((M, 5 * 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((M, 3 * 16)).astype(np.float32))
    ia = torch.from_numpy(rng.integers(0, 5, 7).astype(np.int32))
    ib = torch.from_numpy(rng.integers(0, 3, 7).astype(np.int32))
    got = cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=16)
    want = np.stack([a.numpy()[:, 16 * i:16 * i + 16].T @ b.numpy()[:, 16 * j:16 * j + 16]
                     for i, j in zip(ia.tolist(), ib.tolist())])
    assert got.shape == (7, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **PLAIN_TOL)


def test_gelu_grad_epilogue_is_autograd_and_jax_vjp_of_the_plain_layers():
    """bsmm_ref(dy, W2's cols, W2's tiles transposed, gelu_grad=pre) is
    dpre = (dy . W2^T) * gelu'(pre) of y = bsmm_scatter(gelu(pre), W2)."""
    tcfg, jcfg, jp, params, x, dy = _plain_layers(31)
    M, k = x.shape[0], tcfg.k
    pre = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (M, tcfg.d_ff)).astype(np.float32) * 2)
    pre_g = pre.clone().requires_grad_()
    y = ffn.bsmm_scatter(cuda_bsmm.gelu(pre_g).reshape(M, tcfg.nb_ff, k), params["w2"],
                         tcfg.nb_model)
    (want,) = torch.autograd.grad(y, pre_g, torch.from_numpy(dy).reshape(y.shape))
    w2t = params["w2"]["tiles"].transpose(-1, -2).contiguous()
    got = cuda_bsmm.bsmm_ref(torch.from_numpy(dy), params["w2"]["cols"], w2t, gelu_grad=pre)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PLAIN_TOL)
    for resident in (False, True):  # the wrappers run it on the CPU
        fn = cuda_bsmm.bsmm_resident if resident else cuda_bsmm.bsmm
        np.testing.assert_array_equal(
            fn(torch.from_numpy(dy), params["w2"]["cols"], w2t, block_m=8,
               gelu_grad=pre).numpy(), got.numpy())
    _, vjp = jax.vjp(lambda p: jffn.bsmm_scatter(
        jax.nn.gelu(p).reshape(M, jcfg.nb_ff, k), jp["w2"], jcfg.nb_model),
        jnp.asarray(pre.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        vjp(jnp.asarray(dy).reshape(M, jcfg.nb_model, k))[0]), **PLAIN_TOL)


def test_epilogue_operands_are_checked():
    tcfg, _, _, params, x, dy = _plain_layers(41)
    w2t = params["w2"]["tiles"].transpose(-1, -2).contiguous()
    dyt = torch.from_numpy(dy)
    pre = torch.zeros((dy.shape[0], tcfg.d_ff))
    with pytest.raises(ValueError, match="two epilogues"):
        cuda_bsmm.bsmm(dyt, params["w2"]["cols"], w2t, block_m=8, fuse_gelu=True,
                       gelu_grad=pre)
    with pytest.raises(ValueError, match="gelu_grad"):
        cuda_bsmm.bsmm(dyt, params["w2"]["cols"], w2t, block_m=8, gelu_grad=pre[:, :8])
    with pytest.raises(ValueError, match="gelu_grad"):
        cuda_bsmm.bsmm_ref(dyt, params["w2"]["cols"], w2t, gelu_grad=pre.double())
    a = torch.zeros((8, 32))
    ia = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_bsmm_grad.bsmm_wgrad(a, a, ia.long(), ia, k=16)
    with pytest.raises(ValueError):
        cuda_bsmm_grad.bsmm_wgrad(a, a[:4], ia, ia, k=16)
    with pytest.raises(ValueError):
        cuda_bsmm_grad.bsmm_wgrad(a, a, ia, ia, k=12)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        cuda_bsmm_grad.bsmm_wgrad(a.to("meta"), a.to("meta"), ia.to("meta"), ia.to("meta"),
                                  k=16)


def test_mesh_and_shards():
    mesh = train_mesh(device="cpu")
    assert (mesh.dp, mesh.tp, mesh.rank, mesh.dp_group, mesh.tp_group) == (1, 1, 0, None, None)
    with pytest.raises(ValueError):
        train_mesh(0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        train_mesh(1, 2, device="cpu")  # no process group in this process
    _, _, np_params, x, _ = _inputs()
    params = ffn.params_from_jax(np_params, device="cpu")
    for d, t in ((0, 1), (1, 0)):
        m = TrainMesh(2, 2, d, t, torch.device("cpu"))
        shard = ffn.shard_params(params, m)
        n = params["w1"]["rows"].shape[0] // 2
        assert torch.equal(shard["w1"]["rows"], params["w1"]["rows"][t * n:(t + 1) * n])
        assert torch.equal(shard["w2"]["tiles"], params["w2"]["tiles"][t * n:(t + 1) * n])
        xs = ffn.shard_data(torch.from_numpy(x), m)
        assert torch.equal(xs, torch.from_numpy(x)[2 * d:2 * d + 2, 4 * t:4 * t + 4])
    with pytest.raises(ValueError):
        ffn.shard_data(torch.from_numpy(x), TrainMesh(3, 1, 0, 0, torch.device("cpu")))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_entry_points_default_to_cuda(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        train_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        train_mesh(2, 2)
    step = ffn.make_sharded_train_step(train_mesh(device="cpu"), ffn.BlockSparseFFNConfig(**CFG))
    assert step.mesh.device == torch.device("cpu") and step.lr == 1e-3 and step.block_m == 128
