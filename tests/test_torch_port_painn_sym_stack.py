"""geossl_tpu_torch's symmetric PaiNN message pass and differentiable whole
stack against the JAX package on the CPU, where every kernel wrapper takes
its plain version.

* The symmetric pair (``painn_message_fused_sym``/``painn_bwd_sym``, JAX #10
  and #11) at N=256, F=32, R=20 against the Pallas kernels in interpret
  mode: the forward at rtol 1e-5 with atol 1e-5 times the output's largest
  magnitude (f32 sums over the N=256 senders in another order); the
  backward likewise at rtol 1e-4 (its sums run over up to N pairs, and
  dWk's over N*N). The kernels return the pair cotangents PLACED, each on
  its own tiles (the TPU kernel's, the port's 8x8), so both packages'
  placed cotangents are folded to X + X^T (ddist, dgate) and X - X^T (the
  three ddir), the part of a pair cotangent that reaches symmetric
  (antisymmetric) pair fields, and held to each other and to the plain
  version's unplaced cotangents.
* The placement contract itself in f64 at rtol 1e-12: the gradient through
  the positions is the same with placed and unplaced pair cotangents.
* The differentiable stack (``painn_stack_train``, JAX #12 in
  save_residuals mode): its hand-assembled backward against autograd
  through ``painn_stack_reference`` in f64 at rtol 1e-10; its residuals
  against ``_stack_pallas(save_residuals=True)`` in interpret mode at rtol
  2e-5 / atol 1e-5; ``stack_train_apply`` on a JAX PaiNN tree loaded
  through ``painn_state_dict_from_flax`` against JAX ``stack_train_apply``
  in f32, the value at relative 1e-5 and every gradient (parameters and
  positions) at 1e-3 of its largest magnitude, the JAX package's own
  tolerances (``tests/test_painn_stack_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.painn import stack_train_apply as j_stack_train_apply
from geossl_tpu.ops import painn_pallas as jpp
from geossl_tpu_torch.models.painn import PaiNN, stack_train_apply
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.utils.torch_import import painn_state_dict_from_flax
from tests import test_torch_port_schnet as S
from tests.test_torch_port_ncsn import close

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

F, R, CUT = 32, 20, 5.0
SMALL = dict(n_atom_basis=F, n_interactions=2, n_rbf=R, cutoff=CUT)
PAIR_NAMES = ("ddist", "dgate", "ddirx", "ddiry", "ddirz")


def _sym_case(n, seed, dtype=np.float32, b=1, pad=9):
    """Message-pass inputs with symmetric dist/gate and antisymmetric
    directions (a random walk of n - pad atoms, then padding): (positions,
    mask, (dist, gate, dirx, diry, dirz, x, mu, wk, bk)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(scale=0.9, size=(b, n, 3)), axis=1).astype(dtype)
    mask = np.broadcast_to(np.arange(n) < n - pad, (b, n)).copy()
    d, direction, pm = tgeo.pairwise_directions(torch.from_numpy(pos),
                                                torch.from_numpy(mask))
    adj = tgeo.radius_adjacency(d, pm, CUT)
    gate = 0.5 * (torch.cos(d * np.pi / CUT) + 1.0) * adj.to(d.dtype)
    x, mu = (rng.normal(scale=0.4, size=(b, n, 3 * F)).astype(dtype)
             for _ in range(2))
    wk = rng.normal(scale=0.3, size=(R, 3 * F)).astype(dtype)
    bk = rng.normal(scale=0.1, size=3 * F).astype(dtype)
    dirs = [direction[..., c].numpy().copy() for c in range(3)]
    return pos, mask, (d.numpy(), gate.numpy(), *dirs, x, mu, wk, bk)


def _fold(c, antisymmetric):
    ct = np.swapaxes(c, -1, -2)
    return c - ct if antisymmetric else c + ct


# -- the symmetric pair ---------------------------------------------------------


def test_sym_forward_matches_pallas_interpret():
    _, _, args = _sym_case(256, seed=1)
    assert tpn.sym_profitable(256)
    want = jpp.painn_message_fused_sym(*map(jnp.asarray, args), CUT)
    got = tpn.painn_message(*map(torch.from_numpy, args), CUT, symmetric=True)
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_sym_bwd_placed_matches_pallas_interpret(sparse):
    """The kernels' placed pair cotangents, folded, against each other and
    against the plain version's unplaced ones; dx, dmu, dWk and dbk as they
    are. (Gating zeroes the placed cotangents on empty tiles, where the gate
    has value and slope zero: both packages' folds keep them, the plain
    version's does not, so it is held to the gated fold on occupied cells.)"""
    _, _, args = _sym_case(256, seed=2)
    rng = np.random.default_rng(3)
    gq = rng.normal(size=(1, 256, F)).astype(np.float32)
    gmu = rng.normal(size=(1, 256, 3 * F)).astype(np.float32)
    jax_out = [np.asarray(a) for a in jpp._painn_sym_bwd(
        *map(jnp.asarray, (*args, gq, gmu)), CUT, sparse)]
    plain = [t.numpy() for t in tpn.painn_bwd_sym(
        *map(torch.from_numpy, (*args, gq, gmu)), CUT, sparse)]
    occupied = np.asarray(args[1]) != 0
    for k, name in enumerate(PAIR_NAMES):
        anti = k >= 2
        placed = tcf.place_sym_cotangent(torch.from_numpy(plain[k]),
                                         antisymmetric=anti).numpy()
        want = _fold(plain[k], anti)
        np.testing.assert_allclose(_fold(placed, anti), want, rtol=1e-12,
                                   atol=1e-12, err_msg=name)
        got = _fold(jax_out[k], anti)
        if sparse:  # the kernel's zeros lie where gate == 0 (both orders)
            want = np.where(occupied, want, got)
        close(got, want, rtol=1e-4)
    for g, w in zip(jax_out[5:], plain[5:]):
        close(g.reshape(w.shape), w, rtol=1e-4)


@pytest.mark.parametrize("antisymmetric", [False, True])
def test_placement_keeps_position_gradient_f64(antisymmetric):
    """Positions -> dist, gate and directions; a seeded cotangent on each,
    pushed back to the positions placed and unplaced. The directions are
    antisymmetric: their cotangent must be placed with the sign, and the
    symmetric placement of it would move the position gradient."""
    pos, mask, _ = _sym_case(40, seed=4, dtype=np.float64, b=2, pad=5)
    p = torch.from_numpy(pos).requires_grad_(True)
    d, direction, pm = tgeo.pairwise_directions(p, torch.from_numpy(mask))
    gate = 0.5 * (torch.cos(d * np.pi / CUT) + 1.0) * \
        tgeo.radius_adjacency(d, pm, CUT).to(d.dtype)
    fields = (d, gate, *(direction[..., c] for c in range(3)))
    rng = np.random.default_rng(5)
    cots = [torch.from_numpy(rng.normal(size=d.shape)) for _ in fields]

    def pos_grad(placed):
        cs = [tcf.place_sym_cotangent(c, antisymmetric=k >= 2 and
                                      antisymmetric) if placed else c
              for k, c in enumerate(cots)]
        (g,) = torch.autograd.grad(fields, p, cs, retain_graph=True)
        return g.numpy()

    want, got = pos_grad(False), pos_grad(True)
    if antisymmetric:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:  # the wrong sign for the directions changes the gradient
        assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


# -- the differentiable whole stack ---------------------------------------------


def _stack_inputs(dtype, seed=6):
    z, pos, mask = S.molecules(4, 24, seed, dtype=dtype, spread=1.3)
    model = PaiNN(**SMALL, generator=torch.Generator().manual_seed(seed))
    model = model.to(torch.float64 if dtype == np.float64 else torch.float32)
    with torch.no_grad():
        dist, direction, gate = model.geometry(torch.from_numpy(pos),
                                               torch.from_numpy(mask))
        q0 = model.embed(torch.from_numpy(z).long())
        stacked = model.stacked_weights()
    pair = (dist, gate, *(direction[..., c].contiguous() for c in range(3)))
    return pair, q0, stacked


def test_stack_train_backward_matches_autograd_f64():
    """The hand-assembled backward (per block in reverse: mixing and x-MLP
    VJPs, the message pass through painn_bwd) against autograd through the
    plain chain, for every input: the pair grids, q0, the 11 weight
    stacks."""
    pair, q0, stacked = _stack_inputs(np.float64)
    leaves = [t.clone().requires_grad_(True) for t in (*pair, q0, *stacked)]
    rng = np.random.default_rng(7)
    cq = torch.from_numpy(rng.normal(size=q0.shape))
    cmu = torch.from_numpy(rng.normal(size=q0.shape[:2] + (3 * F,)))

    def grads(fn):
        q, mu = fn(*leaves[:6], leaves[6:], CUT)
        return q, torch.autograd.grad((q * cq).sum() + (mu * cmu).sum(),
                                      leaves)

    q_ref, want = grads(tpn.painn_stack_reference)
    q, got = grads(tpn.painn_stack_train)
    assert q.grad_fn is not None and "StackTrain" in type(q.grad_fn).__name__
    np.testing.assert_allclose(q.detach().numpy(), q_ref.detach().numpy(),
                               rtol=1e-10, atol=1e-12)
    for k, (g, w) in enumerate(zip(got, want)):
        assert w.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-12 * w.abs().max().item(),
                                   err_msg=f"input {k}")


def test_stack_residuals_match_pallas_interpret():
    pair, q0, stacked = _stack_inputs(np.float32)
    want = jpp._stack_pallas(*(jnp.asarray(t.numpy()) for t in (*pair, q0)),
                             tuple(jnp.asarray(t.numpy()) for t in stacked),
                             CUT, 1e-8, save_residuals=True)
    got = tpn.painn_stack_reference(*pair, q0, stacked, CUT,
                                    save_residuals=True)
    assert len(got) == len(want) == 6
    assert (got[3][:, 0] == 0).all()  # mus[:, 0]: mu starts at zero
    for name, g, w in zip(("q", "mu", "qs", "mus", "qps", "mups"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-5, err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("kwargs,clean_graph", [
    ({}, False),
    ({"shared_interactions": True, "shared_filters": True}, False),
    ({}, True),
], ids=["default", "shared", "pair_mask"])
def test_stack_train_apply_matches_jax(kwargs, clean_graph):
    """A JAX PaiNN tree through ``painn_state_dict_from_flax`` into the
    port; value and gradients (parameters, positions) of a graph-level loss
    through both packages' ``stack_train_apply``. With a pair mask (DDM's
    clean graph on perturbed positions) the embedding's padding row 0 gets
    zero gradient on both sides."""
    z, pos, mask = S.molecules(4, 24, 8, dtype=np.float32, spread=1.3)
    z[1, :3] = 0  # atom type 0 in use: the gated padding row
    pair_mask = None
    if clean_graph:
        d, pm = tgeo.pairwise_distances(torch.from_numpy(pos),
                                        torch.from_numpy(mask))
        pair_mask = tgeo.radius_adjacency(d, pm, CUT).numpy()
        pos = (pos + np.random.default_rng(9).normal(scale=0.1, size=pos.shape)
               ).astype(np.float32)
    jm = JPaiNN(**SMALL, **kwargs)
    # the JAX side jitted: its eager ops (the kernel in interpret mode
    # among them) compile one by one
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(z),
                              jnp.asarray(pos), jnp.asarray(mask))["params"]
    cot = np.random.default_rng(10).normal(size=(4, F)).astype(np.float32)
    jpm = None if pair_mask is None else jnp.asarray(pair_mask)

    def jloss(p, x):
        g, _ = j_stack_train_apply(jm, p, jnp.asarray(z), x, jnp.asarray(mask),
                                   jpm)
        return jnp.sum(g * cot)

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(pos))
    model = PaiNN(**SMALL, **kwargs)
    model.load_state_dict(painn_state_dict_from_flax(params, 2))
    p = torch.from_numpy(pos).requires_grad_(True)
    g, _ = stack_train_apply(model, torch.from_numpy(z).long(), p,
                             torch.from_numpy(mask),
                             None if pair_mask is None
                             else torch.from_numpy(pair_mask))
    tv = (g * torch.from_numpy(cot)).sum()
    tv.backward()
    assert abs(tv.item() - float(jv)) <= 1e-5 * abs(float(jv))
    assert _rel(p.grad.numpy(), jgx) < 1e-3
    want = painn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgp), 2)
    for name, par in model.named_parameters():
        assert _rel(par.grad.numpy(), want[name].numpy()) < 1e-3, name
    if clean_graph:
        assert float(np.abs(np.asarray(jgp["embedding"][0])).max()) == 0.0
        assert (model.embedding.weight.grad[0] == 0).all()


def test_stack_train_refuses_f64_positions():
    model = PaiNN(**SMALL)
    z = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="float32"):
        stack_train_apply(model, z, torch.zeros(1, 8, 3, dtype=torch.float64),
                          torch.ones(1, 8, dtype=torch.bool))


def test_stack_train_refuses_large_n():
    model = PaiNN(**SMALL)
    n = tpn.STACK_MAX_N + 8
    assert tpn.STACK_MAX_N == jpp.STACK_MAX_N
    with pytest.raises(ValueError, match="exceeds"):
        stack_train_apply(model, torch.zeros(1, n, dtype=torch.long),
                          torch.zeros(1, n, 3), torch.ones(1, n, dtype=torch.bool))
    pair = [torch.zeros(1, n, n)] * 5
    with pytest.raises(ValueError, match="per-block"):
        tpn.painn_stack_train(*pair, torch.zeros(1, n, F),
                              model.stacked_weights(), CUT)


def test_stack_train_refuses_second_order():
    """A backward that builds a graph (as a double backward needs) raises,
    on the CPU as on the card."""
    pair, q0, stacked = _stack_inputs(np.float32)
    q0 = q0.clone().requires_grad_(True)
    q, _ = tpn.painn_stack_train(*pair, q0, stacked, CUT)
    with pytest.raises(NotImplementedError,
                       match="painn_stack_train is first order"):
        torch.autograd.grad(q.square().sum(), q0, create_graph=True)
