"""SchNet at any Gaussian count, on the CPU.

The CFConv kernels (``ops/csrc/cfconv_fwd.cu`` both modes,
``cfconv_bwd.cu`` both modes, ``schnet_stack.cu``) take any G: up to 64
they keep W1 and the RBF tile in shared memory, above 64 they stream W1 in
chunks of 32 rows (``csrc/filter_mma.cuh``'s ``W1Stream``) and the
backward walks the chunks twice per tile (pass 1: the hidden layer; pass 2:
drbf/ddist and dW1, dW1 added to the block's own partial). Here:

* the wrappers' plain versions of #1-#5 at G = 65, 100 and 300 against the
  JAX Pallas kernels in interpret mode, f32, B=2 at N=16 and N=20 (a pad
  that is no multiple of 8), on SchNet's basis (0 to the 10 A cutoff), at
  chip_smoke.py's kernel tolerances: forwards at rtol 1e-4 / atol 1e-5,
  backwards and the stack at rtol 1e-4 / atol 1e-5 x max (f32 sums over pairs in another
  order; the symmetric backward's ddist/denv folded, as in
  ``test_torch_port_schnet``). The JAX kernels make the RBF offsets as
  start + dk in f32, the plain versions as linspace, an ulp apart, and a
  Gaussian's value moves by ~2|coeff||d - mu| per ulp of its offset, a
  factor that grows with G: at G = 300 that alone takes an output element
  to ~1e-5 (``test_torch_port_schnet``'s rtol 2e-5 holds at G = 8);
* SchNet's forward and every gradient at G = 300 (2 blocks, F = 16) and the
  DDM loss and every gradient at G = 100 against the JAX package in f64 at
  rtol 1e-10;
* the G > 64 scheme in f64: the streamed first product, pass 2's ddist
  (two column halves summed over the chunks) and dW1 (each tile's chunk
  rows added to the block's partial, blocks summed in order) against the
  unchunked math; every dW1 cell of a chunk owned by one lane; the
  double buffer's bookkeeping over walks of 3, 4 and 10 chunks;
* the 3xTF32 numerics of the first product at K = 300 (each chunk's product
  added in f32) through the forward's messages, and of dW1's per-tile sums,
  in the emulation of ``test_torch_port_cfconv_tc``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.utils.torch_import import schnet_state_dict_from_flax
from tests import test_torch_port_cfconv_tc as TC
from tests import test_torch_port_schnet as S
from tests import test_torch_port_train as T

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

GS = (65, 100, 300)
CUT = 10.0  # SchNet's cutoff, the basis's stop
KC = 32  # rows of a streamed W1 chunk (filter_mma.cuh kKC)
BWD_NAMES = ("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2")


def _inputs(n, seed, g, max_neighbors=None, b=2, f=16):
    """f32 (dist, env, x, [W1, b1, W2, b2], cotangent): b random-walk
    molecules padded to n, env the cosine envelope of the radius graph
    (with ``max_neighbors``: not symmetric)."""
    _, pos, mask = S.molecules(b, n, seed, dtype=np.float32, spread=1.5)
    td, tm = tgeo.pairwise_distances(torch.from_numpy(pos),
                                     torch.from_numpy(mask))
    adj = tgeo.radius_adjacency(td, tm, CUT, max_neighbors)
    env = 0.5 * (torch.cos(td * np.pi / CUT) + 1.0) * adj.to(td.dtype)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    w = [rng.normal(scale=s, size=shape).astype(np.float32) for shape, s in
         (((g, f), 0.5), ((f,), 0.1), ((f, f), 0.3), ((f,), 0.1))]
    ct = rng.normal(size=(b, n, f)).astype(np.float32)
    return td.numpy(), env.numpy(), x, w, ct


def _close(got, want, what, rtol=1e-4, scaled=True):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * (np.abs(want).max() if scaled else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# -- the plain versions of #1-#5 against the JAX Pallas kernels (interpret) --


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "fwd_sym", "bwd_sym"])
def test_cfconv_plain_versions_match_pallas_interpret(kernel, g):
    args = (0.0, CUT, g)
    for n in (16, 20):
        sym = kernel.endswith("sym")
        d, e, x, w, ct = _inputs(n, 3 + n, g, None if sym else 4)
        if not sym:
            assert not np.array_equal(e, np.swapaxes(e, 1, 2))
        jin = [jnp.asarray(a) for a in (d, e, x, *w)]
        tin = [torch.from_numpy(a) for a in (d, e, x, *w)]
        if kernel == "fwd":
            _close(tcf.cfconv_fused(*tin, *args, True),
                   jcf.cfconv_fused(*jin, *args, "f32", True), f"N={n}",
                   scaled=False)
        elif kernel == "fwd_sym":
            _close(tcf.cfconv_fused_sym(*tin, *args, True),
                   jcf.cfconv_fused_sym(*jin, *args, "f32", True), f"N={n}",
                   scaled=False)
        else:
            bwd = tcf.cfconv_bwd_sym if sym else tcf.cfconv_bwd
            jbwd = jcf._cfconv_sym_bwd if sym else jcf._cfconv_bwd
            got = bwd(*tin[:3], torch.from_numpy(ct), *tin[3:], *args)
            want = jbwd(*jin, jnp.asarray(ct), *args, "f32", False)
            for k, (a, b) in enumerate(zip(got, want)):
                a, b = a.numpy(), np.asarray(b)
                if sym and k < 2:  # each side places a pair's cotangents
                    a, b = S._fold(a), S._fold(b)
                _close(a, b, f"N={n} {BWD_NAMES[k]}")


@pytest.mark.parametrize("g", GS)
def test_stack_plain_version_matches_pallas_interpret(g):
    """#5: ``schnet_stack``'s plain version (the whole-stack chain on the
    CPU) against ``schnet_stack_infer`` in interpret mode, f32, 2 blocks, on
    the symmetric graph and on a max_neighbors one."""
    rng = np.random.default_rng(g)
    for n, mn in ((16, None), (20, 4)):
        d, e, _, _, _ = _inputs(n, 30 + n, g, mn)
        f, layers = 16, 2
        h0 = rng.normal(size=(2, n, f)).astype(np.float32)
        stacked = [rng.normal(scale=s, size=(layers, *shape)).astype(np.float32)
                   for shape, s in (((f, f), 0.3), ((g, f), 0.5), ((f,), 0.1),
                                    ((f, f), 0.3), ((f,), 0.1), ((f, f), 0.3),
                                    ((f,), 0.1), ((f, f), 0.3), ((f,), 0.1))]
        want = jcf.schnet_stack_infer(jnp.asarray(d), jnp.asarray(e),
                                      jnp.asarray(h0),
                                      tuple(map(jnp.asarray, stacked)), 0.0,
                                      CUT, g)
        got = tcf.schnet_stack(torch.from_numpy(d), torch.from_numpy(e),
                               torch.from_numpy(h0),
                               [torch.from_numpy(a) for a in stacked], 0.0,
                               CUT, g, mn is None)
        # scaled atol, as the doctor holds the stack: h sums each block's
        # update, so the error scales with h, not with the element
        _close(got, want, f"N={n}")


# -- the model and the DDM slice in f64 ----------------------------------------


def test_schnet_g300_forward_and_every_gradient_match_jax_f64():
    kw = dict(hidden_channels=16, num_filters=16, num_interactions=2,
              num_gaussians=300, cutoff=CUT)
    z, pos, mask = S.molecules(3, 20, seed=41, spread=1.5)
    m = JSchNet(**kw)
    with S.x64():
        params = jax.jit(m.init)(jax.random.PRNGKey(4), jnp.asarray(z),
                                 jnp.asarray(pos, jnp.float32),
                                 jnp.asarray(mask))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

        def loss(p, xyz):
            g, h = m.apply({"params": p}, jnp.asarray(z), xyz,
                           jnp.asarray(mask))
            return jnp.sum(jnp.tanh(g)) + 0.1 * jnp.sum(h * h), (g, h)

        (jl, (jg, jh)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(pos))
        jgp = jax.tree_util.tree_map(np.asarray, jgp)
    model = SchNet(**kw).double()
    model.load_state_dict(schnet_state_dict_from_flax(params))
    xyz = torch.from_numpy(pos).requires_grad_(True)
    g, h = model(torch.from_numpy(z).long(), xyz, torch.from_numpy(mask))
    (torch.tanh(g).sum() + 0.1 * (h * h).sum()).backward()
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(xyz.grad.numpy(), np.asarray(jgx), rtol=1e-10,
                               atol=1e-12)
    want = schnet_state_dict_from_flax(jgp)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_ddm_g100_loss_and_every_gradient_match_jax_f64(monkeypatch):
    """The DDM slice of ``test_torch_port_train`` with SchNet at G = 100."""
    kw = {**S.SMALL, "num_gaussians": 100, "cutoff": CUT}
    monkeypatch.setitem(T._BACKBONES, "schnet", (
        lambda: JSchNet(**kw), lambda: SchNet(**kw),
        schnet_state_dict_from_flax, contextlib.nullcontext))
    case = T.ddm_jax_case("schnet")
    pos2, draws = T._step_inputs(case["pos"], case["mask"], 0)
    with S.x64():
        want, jgrad = case["jax_value_and_grad"](
            case["params"], *map(jnp.asarray, case["arrays"]),
            jnp.asarray(pos2), tuple(map(jnp.asarray, draws)))
        jgrad = jax.tree_util.tree_map(np.asarray, jgrad)
    ddm = case["port"]()
    assert ddm.model.num_gaussians == 100
    loss = T._port_loss(ddm, case, pos2, draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-10)
    grads = T._as_port_state(jgrad, case["to_port"])
    named = dict(ddm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# -- the G > 64 scheme in f64 ------------------------------------------------


def _tile_case(rng, g, f, tiles, stop=CUT):
    """Per tile: 64 pair distances, the RBF [64, g], and a hidden-layer
    cotangent dh [64, f]; the basis (offsets, coeff) and W1 [g, f]."""
    off = np.linspace(0.0, stop, g)
    coeff = -0.5 / (off[1] - off[0]) ** 2
    w1 = rng.normal(0.0, 1.0 / np.sqrt(g), (g, f))
    d = rng.uniform(0.5, stop, (tiles, 64))
    rbf = np.exp(coeff * (d[..., None] - off) ** 2)
    dh = rng.normal(0.0, 1.0, (tiles, 64, f))
    return off, coeff, w1, d, rbf, dh


def _chunks(g):
    return [(c, slice(c * KC, min(g, (c + 1) * KC))) for c in range(-(-g // KC))]


@pytest.mark.parametrize("g", GS)
def test_streamed_passes_are_the_unchunked_math_f64(g):
    """Pass 1 (rbf W1 summed over the chunks), pass 2's ddist (per chunk
    drbf = dh W1_c^T times rbf 2 coeff (d - off), summed per pair over the
    chunks in each of the two column halves of a chunk, then the halves
    added) and dW1 (each tile's rbf_c^T dh added to its block's partial rows,
    in tile order; the blocks' partials summed in block order, as
    ``sum_partials``) against the unchunked f64 math."""
    rng = np.random.default_rng(g)
    f, tiles, blocks = 16, 11, 4
    off, coeff, w1, d, rbf, dh = _tile_case(rng, g, f, tiles)
    for t in range(tiles):
        h = sum(rbf[t][:, s] @ w1[s] for _, s in _chunks(g))
        np.testing.assert_allclose(h, rbf[t] @ w1, rtol=1e-12, atol=1e-14)
        want = np.sum((dh[t] @ w1.T) * rbf[t] * 2 * coeff
                      * (d[t][:, None] - off), axis=1)
        halves = np.zeros((2, 64))
        for c, s in _chunks(g):
            drbf = dh[t] @ w1[s].T
            for half in range(2):
                cols = np.arange(s.start, s.stop)
                keep = (cols - c * KC) // 16 == half
                cols = cols[keep]
                halves[half] += np.sum(
                    drbf[:, keep] * rbf[t][:, cols] * 2 * coeff
                    * (d[t][:, None] - off[cols]), axis=1)
        np.testing.assert_allclose(halves[0] + halves[1], want, rtol=1e-12,
                                   atol=1e-12)
    part = np.zeros((blocks, g, f))
    for k, run in enumerate(np.array_split(np.arange(tiles), blocks)):
        for t in run:
            for _, s in _chunks(g):
                part[k, s] += rbf[t][:, s].T @ dh[t]
    dw1 = np.zeros((g, f))
    for k in range(blocks):
        dw1 = dw1 + part[k]
    want = sum(rbf[t].T @ dh[t] for t in range(tiles))
    np.testing.assert_allclose(dw1, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g", GS)
def test_dw1_chunk_cells_are_each_owned_by_one_lane(g):
    """``cfconv_bwd.cu``'s ``dw1_chunk_cells``: over the 8 warps and 32
    lanes, chunk c's cells (rows 32c + 16 mb + g + 8 h < G, columns 16 w +
    8 nb + 2 t + 0/1) cover every cell of dW1 [G, 128] once, and nothing
    at rows >= G (the partial's db1 follows dW1 in memory)."""
    count = np.zeros((-(-g // KC) * KC, 128), int)
    for c, _ in _chunks(g):
        for w in range(8):
            for lane in range(32):
                gl, t = lane >> 2, lane & 3
                for mb in range(2):
                    for h in range(2):
                        r = c * KC + 16 * mb + gl + 8 * h
                        if r >= g:
                            continue
                        for nb in range(2):
                            col = 16 * w + 8 * nb + 2 * t
                            count[r, col:col + 2] += 1
    assert (count[:g] == 1).all() and (count[g:] == 0).all()


def _walk(n_chunks, walks_more, buffers, k, log):
    """One walk of ``W1Stream`` over chunks 0 .. n - 1 as
    ``rbf_w1_streamed`` and the backward's pass 2 run it: chunk k of the
    block's sequence is read from buffer k & 1, and each step (after its
    barrier) fetches the next chunk into the other buffer: the walk's next,
    or after its last chunk 0 of the next walk when ``walks_more``."""
    for c in range(n_chunks):
        log.append((buffers[k & 1], c))
        if c + 1 < n_chunks:
            buffers[(k + 1) & 1] = c + 1
        elif walks_more:
            buffers[(k + 1) & 1] = 0
        k += 1
    return k


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("kind", ["forward", "stack", "backward"])
def test_w1_stream_reads_the_chunk_it_fetched(kind, g):
    """The double buffer's bookkeeping over a block's tiles: the forward
    kernels walk the chunks once per tile and fetch the next tile's chunk 0
    only when a tile follows; the stack restarts at buffer 0 each message
    phase; the backward walks twice per tile and always fetches (the block
    waits for the last fetch before it ends). Every read finds the chunk it
    expects, with walks of an odd chunk count (G = 65: 3) too."""
    n = -(-g // KC)
    log = []
    if kind == "backward":
        buffers, k = [0, None], 0
        for _ in range(5):
            k = _walk(n, True, buffers, k, log)  # pass 1
            k = _walk(n, True, buffers, k, log)  # pass 2
    else:
        phases = 3 if kind == "stack" else 1
        for _ in range(phases):
            buffers, k, tiles = [0, None], 0, 5
            for t in range(tiles):
                k = _walk(n, t + 1 < tiles, buffers, k, log)
    assert all(got == want for got, want in log), log


# -- 3xTF32 at K = 300 --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_streamed_first_product_meets_the_forward_tolerance(seed):
    """The forward's filter at G = 300 on SchNet's basis, as the kernels
    compute it above 64: rbf [64 x 320] W1 in the plain 3xTF32 split, each
    chunk's product (K = 32, the tensor core's truncating accumulator) added
    to the sum in f32, then ssp and W2 (plain split) and the messages of 13
    tiles of a row: within chip_smoke.py's rtol 1e-4 / atol 1e-5 of the f64
    message at under half the tolerance."""
    rng = np.random.default_rng(seed)
    g_n, f, tiles = 300, 128, 13
    off = np.linspace(0.0, CUT, g_n)
    coeff = -0.5 / (off[1] - off[0]) ** 2
    w1 = np.zeros((320, f))
    w1[:g_n] = rng.normal(0.0, 1.0 / np.sqrt(g_n), (g_n, f))
    b1, b2 = rng.normal(0.0, 0.1, f), rng.normal(0.0, 0.1, f)
    w2 = rng.normal(0.0, 1.0 / np.sqrt(f), (f, f))
    want, got = np.zeros((8, f)), torch.zeros(8, f, dtype=torch.float32)
    for _ in range(tiles):
        d = rng.uniform(0.8, CUT, (8, 8))
        env, x = rng.uniform(0.0, 1.0, (8, 8)), rng.normal(0.0, 1.0, (8, f))
        rbf = np.zeros((64, 320))
        rbf[:, :g_n] = np.exp(coeff * (d.reshape(64, 1) - off) ** 2)
        w = (np.logaddexp(rbf @ w1 + b1, 0.0) - np.log(2.0)) @ w2 + b2
        want += np.einsum("ij,ijf,jf->if", env, w.reshape(8, 8, f), x)
        h = torch.zeros(64, f, dtype=torch.float32)
        for c in range(10):
            s = slice(c * KC, (c + 1) * KC)
            h = (h.double() + TC.mma_chain([(TC._f32(rbf[:, s]), TC._f32(w1[s]))],
                                           False).double()).float()
        h = h + TC._f32(b1)
        s_ = torch.logaddexp(h, torch.zeros_like(h)) - np.log(2.0)
        wk = TC.mma_chain([(s_, TC._f32(w2))], False) + TC._f32(b2)
        got += torch.einsum("ij,ijf,jf->if", TC._f32(env), wk.view(8, 8, f),
                            TC._f32(x))
    want = torch.from_numpy(want)
    ratio = ((got.double() - want).abs() / (1e-5 + 1e-4 * want.abs())).max().item()
    assert ratio < 0.5, ratio


def test_dw1_tile_sums_stay_at_f32():
    """dW1's chunk rows over a run of 16 tiles: each tile's rbf_c^T dh (K =
    64 pairs, plain split) added to the partial in f32, as pass 2 does,
    stays within f32 rounding of the f64 sum."""
    rng = np.random.default_rng(7)
    off, coeff, w1, d, rbf, dh = _tile_case(rng, 300, 128, 16)
    s = slice(4 * KC, 5 * KC)
    pairs = [(TC._f32(rbf[t][:, s].T), TC._f32(dh[t])) for t in range(16)]
    want = sum(a.double() @ b.double() for a, b in pairs)
    got = TC.mma_chain(pairs, False, tile_sums=True)
    rel = ((got.double() - want).norm() / want.norm()).item()
    assert rel < 1e-6, rel
