"""PaiNN's route to the symmetric message-pass pair, on the CPU.

``PaiNN.forward`` passes ``symmetric=True`` to ``ops/painn.painn_message``
exactly when its pair grids are symmetric (no ``max_neighbors``, no
caller's ``pair_mask``), and the dispatcher takes ``painn_fwd_sym`` /
``painn_bwd_sym`` from N=256 (``sym_profitable``). On the CPU those
wrappers run their plain versions, so:

* f64 at rtol 1e-10, N=256 (one padded molecule, two narrow blocks): the
  port's forward through that route, and the gradients of a scalar loss to
  the positions and to every weight, against the JAX package's PaiNN on the
  same weights, jitted, with real f64 on both sides (``f64_casts``). The
  JAX model reaches its message-pass kernel there (``use_pallas``), which
  this test runs through the JAX package's plain version of that kernel
  (``painn_pallas.painn_message_reference``: the kernels' RBF, whose
  coefficient is the exact offset step), as the JAX package's own tests run
  a kernel by its reference. The model's XLA branch rounds the RBF width
  in the working dtype instead (~1e-8 apart; ``test_torch_port_painn``
  holds the port's ``plain=True`` path to that branch).
* The route rule: ``max_neighbors``, a ``pair_mask`` or N < 256 each keep
  the plain pair (the dispatcher's calls counted by monkeypatched
  wrappers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.ops import painn_pallas as jpp
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.utils.torch_import import painn_state_dict_from_flax
from tests import test_torch_port_schnet as S
from tests.test_torch_port_painn import SMALL, _jax_params, f64_casts

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

N, ATOMS = 256, 200


def _molecule(n=N, atoms=ATOMS, seed=11):
    """One random-walk molecule of ``atoms`` atoms in ``n`` slots."""
    rng = np.random.default_rng(seed)
    z = np.zeros((1, n), np.int32)
    pos = np.zeros((1, n, 3))
    mask = np.zeros((1, n), bool)
    z[0, :atoms] = rng.integers(1, 9, atoms)
    pos[0, :atoms] = np.cumsum(rng.normal(scale=1.3, size=(atoms, 3)), 0)
    mask[0, :atoms] = True
    return z, pos, mask


@pytest.fixture
def routes(monkeypatch):
    """Counts of the dispatcher's calls into each pair's wrapper."""
    calls = {"sym": 0, "plain": 0}
    for key, name in (("sym", "painn_message_fused_sym"),
                      ("plain", "painn_message_fused")):
        inner = getattr(tpn, name)

        def counted(*a, _inner=inner, _key=key, **k):
            calls[_key] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(tpn, name, counted)
    return calls


def test_routed_painn_matches_jax_f64(routes, monkeypatch):
    z, pos, mask = _molecule()
    rng = np.random.default_rng(12)
    wg, wh = rng.normal(size=(1, SMALL["n_atom_basis"])), rng.normal(
        size=(1, N, SMALL["n_atom_basis"]))
    # the JAX model's kernel route through its kernel's plain version
    monkeypatch.setattr(
        jpp, "painn_message",
        lambda *a, symmetric, sparse: jpp.painn_message_reference(*a))
    m = JPaiNN(**SMALL, use_pallas=True)
    with S.x64(), f64_casts():
        params = _jax_params(m, z, pos, mask)

        def loss(params, pos):
            g, h = m.apply({"params": params}, jnp.asarray(z), pos,
                           jnp.asarray(mask))
            return jnp.sum(g * wg) + jnp.sum(jnp.tanh(h) * wh), (g, h)

        (_, (jg, jh)), (jgp, jgpos) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(pos))
        jg, jh, jgpos = map(np.asarray, (jg, jh, jgpos))
        jgp = jax.tree_util.tree_map(np.asarray, jgp)

    model = PaiNN(**SMALL).double()
    model.load_state_dict(painn_state_dict_from_flax(params, 2))
    tpos = torch.from_numpy(pos).requires_grad_(True)
    g, h = model(torch.from_numpy(z).long(), tpos, torch.from_numpy(mask))
    out = (g * torch.from_numpy(wg)).sum() + (torch.tanh(h)
                                              * torch.from_numpy(wh)).sum()
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(out, [tpos, *ps])
    assert routes == {"sym": 2, "plain": 0}
    assert h.dtype == torch.float64
    np.testing.assert_allclose(h.detach().numpy(), jh, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g.detach().numpy(), jg, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(grads[0].numpy(), jgpos, rtol=1e-10,
                               atol=1e-12)
    assert np.abs(jgpos[0, :ATOMS]).max() > 0  # positions get a gradient
    want = painn_state_dict_from_flax(jgp, 2)
    assert sorted(want) == sorted(names)
    for name, grad in zip(names, grads[1:]):
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("n,kwargs,clean_graph,route", [
    (N, {}, False, "sym"),
    (N, {"max_neighbors": 8}, False, "plain"),
    (N, {}, True, "plain"),
    (128, {}, False, "plain"),
], ids=["symmetric", "max_neighbors", "pair_mask", "n128"])
def test_route_rule(routes, n, kwargs, clean_graph, route):
    z, pos, mask = _molecule(n, min(ATOMS, n - 8))
    z, pos, mask = (torch.from_numpy(a) for a in (z, pos, mask))
    pair_mask = None
    if clean_graph:
        d, pm = tgeo.pairwise_distances(pos, mask)
        pair_mask = tgeo.radius_adjacency(d, pm, SMALL["cutoff"])
    model = PaiNN(**SMALL, **kwargs)
    with torch.no_grad():
        model(z.long(), pos.float(), mask, pair_mask)
    other = "plain" if route == "sym" else "sym"
    assert routes[route] == SMALL["n_interactions"] and routes[other] == 0
    assert tpn.sym_profitable(n) == (n >= 256)
