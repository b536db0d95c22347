"""The device work lists of the redesigned kernels, modelled in float64 on
the CPU: the tile list of ``csrc/worklist.cuh`` (``make_tile_list``) and its
split into equal runs (``run_begin``) or into runs of whole items
(``first_item``), the symmetric CFConv forward's runs with their mirrored
messages and the plain CFConv forward's equal runs with their split items'
partials (``csrc/cfconv_fwd.cu``), PaiNN's forward over runs of whole items
(``csrc/painn_fwd.cu``), the PaiNN stack's phases (``csrc/painn_stack.cu``),
and the NCSN forward's row partials and backward's du partials summed in
list order (``csrc/ncsn_score.cu``: ``ncsn_fwd_kernel`` and
``ncsn_bwd_kernel`` write them, ``ncsn_rows_kernel`` and ``ncsn_du_kernel``
sum them).
"""

import numpy as np
import pytest
import torch

from geossl_tpu_torch.models.common import cosine_envelope
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.ops import painn as tpn

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

TILE = 8


def tile_list(grid, sym, sparse=True):
    """``make_tile_list`` on a [B, ni, nj] grid: items (graph, 8-row i tile)
    in order, each listing its computed j tiles in order (with ``sym`` only
    pj >= pi; with ``sparse`` only tiles holding a nonzero entry). Returns
    the list of (b, pi, pj), pos {(b, pi, pj): list position} and the
    prefix sums pre [B * nti + 1]."""
    b_n, ni, nj = grid.shape
    nti, ntj = -(-ni // TILE), -(-nj // TILE)
    nz = np.zeros((b_n, nti * TILE, ntj * TILE), bool)
    nz[:, :ni, :nj] = np.asarray(grid) != 0
    occ = nz.reshape(b_n, nti, TILE, ntj, TILE).any(axis=(2, 4))
    lst, pos, pre = [], {}, [0]
    for b in range(b_n):
        for pi in range(nti):
            for pj in range(ntj):
                if (not sym or pi <= pj) and (occ[b, pi, pj] or not sparse):
                    pos[b, pi, pj] = len(lst)
                    lst.append((b, pi, pj))
            pre.append(len(lst))
    return lst, pos, pre


def run_begin(total, blocks, k):
    return total * k // blocks


def runs(total, blocks):
    return [range(run_begin(total, blocks, k), run_begin(total, blocks, k + 1))
            for k in range(blocks)]


def first_item(pre, blocks, k):
    """``first_item``: the first item whose block, by work, is >= k (item i
    goes to the block holding the middle of its work)."""
    n = len(pre) - 1
    t2 = 2 * max(pre[n], 1)
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if min(blocks - 1, (pre[mid] + pre[mid + 1]) * blocks // t2) >= k:
            hi = mid
        else:
            lo = mid + 1
    return lo


def du_blocks(pre, item, blocks):
    """The blocks ``ncsn_du_kernel`` reads the i-side segments of ``item``
    from: from the last block starting at or before its first tile, while a
    block starts before its end, skipping empty runs."""
    total, t0, t1 = pre[-1], pre[item], pre[item + 1]
    if t1 <= t0:
        return []
    k = -(-(t0 + 1) * blocks // total) - 1
    out = []
    while k < blocks and run_begin(total, blocks, k) < t1:
        if run_begin(total, blocks, k + 1) > run_begin(total, blocks, k):
            out.append(k)
        k += 1
    return out


def _geometry(seed, sizes, n, cutoff=5.0):
    """Symmetric dist/env [B, n, n] (f64) of random molecules with ``sizes``
    atoms (0: an empty graph slot), padded to n."""
    rng = np.random.default_rng(seed)
    b_n = len(sizes)
    pos = torch.from_numpy(rng.normal(scale=2.0, size=(b_n, n, 3)))
    mask = torch.zeros(b_n, n, dtype=torch.bool)
    for b, s in enumerate(sizes):
        mask[b, :s] = True
    dist = torch.cdist(pos, pos)
    pm = mask[:, :, None] & mask[:, None, :] & ~torch.eye(n, dtype=torch.bool)
    env = cosine_envelope(dist, cutoff) * pm
    return torch.where(pm, dist, torch.zeros_like(dist)), env, mask


@pytest.mark.parametrize("sizes,n,blocks,sym,sparse", [
    ((20, 0, 13, 3), 24, 5, True, True),
    ((20, 0, 13, 3), 24, 5, True, False),
    ((30, 7, 0, 17, 30), 32, 132, False, True),
    ((9,), 16, 2, True, True),
])
def test_runs_cover_each_listed_tile_once_and_evenly(sizes, n, blocks, sym, sparse):
    _, env, _ = _geometry(len(sizes), sizes, n)
    lst, pos, pre = tile_list(env, sym, sparse)
    total, nt = len(lst), -(-n // TILE)
    assert pre[-1] == total and all(pos[t] == i for i, t in enumerate(lst))
    rs = runs(total, blocks)
    covered = sorted(t for r in rs for t in r)
    assert covered == list(range(total))  # each listed tile in one run
    lengths = [len(r) for r in rs]
    assert max(lengths) - min(lengths) <= 1
    # the NCSN backward's i-side segments (block k, item): slot item + k is
    # unique, below items + blocks, and the du pass finds exactly the blocks
    # whose runs hold tiles of the item
    segs = {(lst[t][0] * nt + lst[t][1], k) for k, r in enumerate(rs) for t in r}
    slots = [item + k for item, k in segs]
    assert len(set(slots)) == len(slots) and max(slots, default=0) < len(sizes) * nt + blocks
    for item in range(len(sizes) * nt):
        assert du_blocks(pre, item, blocks) == sorted(k for it, k in segs if it == item)


def _filter(dist, w1, b1, w2, b2, cutoff, g):
    rbf = tcf.gaussian_smearing(dist, 0.0, cutoff, g)
    return tcf.shifted_softplus(rbf @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("blocks,sparse", [(1, True), (7, True), (7, False), (132, True)])
def test_symmetric_forward_runs_are_the_dense_message_f64(blocks, sparse):
    """cfconv_fwd_sym_kernel's scheme: block k walks its run of the tile
    list; rows i of a tile are summed in registers while the run stays in one
    row tile and added when it moves on (and at the run's end); a tile with
    pi < pj adds its mirrored messages w x_i to rows j. With symmetric
    dist/env that is the dense message of the plain version."""
    n, f, g, cutoff = 20, 16, 8, 5.0
    dist, env, _ = _geometry(3, (20, 0, 11), n, cutoff)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, n, f)))
    w1, w2 = (torch.from_numpy(rng.normal(scale=0.3, size=s)) for s in ((g, f), (f, f)))
    b1, b2 = (torch.from_numpy(rng.normal(scale=0.3, size=f)) for _ in range(2))
    want = tcf.cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, 0.0, cutoff, g)
    lst, _, _ = tile_list(env, sym=True, sparse=sparse)
    m = -(-n // TILE) * TILE  # padded to whole tiles, as the kernel's loads are
    ew_all = torch.zeros(3, m, m, f, dtype=x.dtype)
    ew_all[:, :n, :n] = env[..., None] * _filter(dist, w1, b1, w2, b2, cutoff, g)
    xp = torch.zeros(3, m, f, dtype=x.dtype)
    xp[:, :n] = x
    got = torch.zeros(3, m, f, dtype=x.dtype)
    for r in runs(len(lst), blocks):
        cur, racc = None, None
        for t in r:
            b, pi, pj = lst[t]
            if (b, pi) != cur:
                if cur is not None:
                    got[cur[0], TILE * cur[1]:TILE * cur[1] + TILE] += racc
                cur, racc = (b, pi), torch.zeros(TILE, f, dtype=x.dtype)
            i, j = slice(TILE * pi, TILE * pi + TILE), slice(TILE * pj, TILE * pj + TILE)
            ew = ew_all[b, i, j]
            racc += torch.einsum("ijf,jf->if", ew, xp[b, j])
            if pi != pj:
                got[b, j] += torch.einsum("ijf,if->jf", ew, xp[b, i])
        if cur is not None:
            got[cur[0], TILE * cur[1]:TILE * cur[1] + TILE] += racc
    got = got[:, :n]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _head(rng, emb):
    shapes = tns.weight_shapes(emb)
    return [torch.from_numpy(rng.normal(scale=0.5, size=s)) for s in shapes]


def _dl1(dist, noise, sel, sigma, u, g_rows, weights, anneal):
    """d rows / d pre1 [B, n, n, emb] for the cotangent g_rows: the masked
    l1 gradient the kernel's du partials sum (the plain head's math)."""
    w_d1, b_d1, w_d2, b_d2, w_od, b_od, w2, b2, w3, b3 = weights
    used = sigma[:, None, None]
    demb = torch.relu((dist + noise * used)[..., None] * w_d1[0] + b_d1) @ w_d2 + b_d2
    pre1 = (u[:, :, None, :] + u[:, None, :, :] + demb @ w_od + b_od).detach()
    pre1.requires_grad_(True)
    x2 = torch.relu(torch.relu(pre1) @ w2 + b2)
    scores = (x2 @ w3 + b3)[..., 0] / used
    rows = (0.5 * (scores + noise / used) ** 2 * used**anneal * sel).sum(2)
    (g,) = torch.autograd.grad(rows, pre1, g_rows)
    return g


@pytest.mark.parametrize("blocks", [3, 50])
def test_ncsn_du_partials_in_list_order_are_the_reference_du_f64(blocks):
    """ncsn_bwd_kernel writes, per listed tile (sel not all zero), the j side
    of du (rows j summed over the tile's rows i) at its list position, and
    per (block, item) segment the i side (rows i summed over the segment's
    tiles, in two halves of the tile's columns) at slot item + block;
    ncsn_du_kernel adds, per row, the item's segments in block order and
    then the j sides of the tiles (qi, pi) in order of qi. On a batch with
    padding and an empty graph slot that is the plain version's du."""
    n, emb, anneal = 20, 8, 2.0
    sizes = (17, 0, 12)
    dist, _, mask = _geometry(5, sizes, n)
    rng = np.random.default_rng(6)
    pm = mask[:, :, None] & mask[:, None, :]
    sel = (torch.triu(torch.ones(n, n, dtype=torch.bool), 1) & pm).double()
    noise = torch.from_numpy(rng.normal(size=dist.shape))
    sigma = torch.from_numpy(rng.uniform(0.1, 2.0, len(sizes)))
    u = torch.from_numpy(rng.normal(size=(len(sizes), n, emb)))
    g_rows = torch.from_numpy(rng.normal(size=(len(sizes), n)))
    weights = _head(rng, emb)
    want = tns.ncsn_score_bwd_reference(dist, noise, sel, sigma, u, g_rows, *weights,
                                        anneal=anneal)[0]
    dl1 = _dl1(dist, noise, sel, sigma, u, g_rows, weights, anneal)

    lst, pos, pre = tile_list(sel, sym=False)
    nt = -(-n // TILE)
    pad = torch.zeros(len(sizes), nt * TILE, nt * TILE, emb, dtype=dl1.dtype)
    pad[:, :n, :n] = dl1
    part_j = {}  # list position -> [8 rows j, emb]
    part_i = {}  # (slot, half) -> [8 rows i, emb]
    for k, r in enumerate(runs(len(lst), blocks)):
        for t in r:
            b, pi, pj = lst[t]
            tile = pad[b, TILE * pi:TILE * pi + TILE, TILE * pj:TILE * pj + TILE]
            part_j[t] = tile.sum(0)
            for half in (0, 1):
                key = (b * nt + pi + k, half)
                cols = tile[:, 4 * half:4 * half + 4].sum(1)
                part_i[key] = part_i.get(key, 0) + cols
    got = torch.zeros(len(sizes), nt * TILE, emb, dtype=dl1.dtype)
    for b in range(len(sizes)):
        for pi in range(nt):
            item = b * nt + pi
            s = torch.zeros(TILE, emb, dtype=dl1.dtype)
            for k in du_blocks(pre, item, blocks):
                s = s + part_i[item + k, 0]
                s = s + part_i[item + k, 1]
            for qi in range(nt):
                if (b, qi, pi) in pos:
                    s = s + part_j[pos[b, qi, pi]]
            got[b, TILE * pi:TILE * pi + TILE] = s
    torch.testing.assert_close(got[:, :n], want, rtol=1e-12, atol=1e-12)
    assert not got[1].any()  # the empty slot


def _painn_case(seed, sizes, n, f=4, r=6, cutoff=5.0):
    """PaiNN's message-pass inputs in f64: symmetric dist and gate (cosine
    cutoff within the radius), antisymmetric directions, x and mu [B, n, 3f],
    Wk [r, 3f] and bk."""
    dist, gate, mask = _geometry(seed, sizes, n, cutoff)
    rng = np.random.default_rng(seed + 1)
    b_n = len(sizes)
    v = torch.from_numpy(rng.normal(size=(b_n, n, n, 3)))
    dirs = (v - v.transpose(1, 2)) * (gate != 0)[..., None]
    x, mu = (torch.from_numpy(rng.normal(size=(b_n, n, 3 * f))) for _ in range(2))
    wk = torch.from_numpy(rng.normal(scale=0.5, size=(r, 3 * f)))
    bk = torch.from_numpy(rng.normal(scale=0.5, size=3 * f))
    return (dist, gate, *(dirs[..., c].contiguous() for c in range(3)), x, mu, wk, bk,
            cutoff), mask


@pytest.mark.parametrize("blocks,sparse", [(1, True), (6, True), (6, False), (132, True)])
def test_painn_forward_item_runs_write_each_row_once_f64(blocks, sparse):
    """painn_fwd_mma_kernel's scheme: block k walks the listed tiles of its
    items [first_item(k), first_item(k + 1)) in list order; a row's sums are
    kept in two halves (the warps wm = 0, 1: columns jl 0-3 and 4-7 of every
    tile) and added, half 0 then half 1, once when the run leaves the item;
    the rows of items with no listed tile are written as zeros by block
    item % blocks. On a batch with padding and an empty graph slot every
    row is written exactly once and the result is the plain version's."""
    args, _ = _painn_case(7, (20, 0, 13), 24)
    dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff = args
    want = torch.cat(tpn.painn_message_reference(*args), dim=-1)
    b_n, n, f3 = x.shape
    f = f3 // 3
    nt = -(-n // TILE)
    m = nt * TILE  # padded to whole tiles, as the kernel's loads are
    # per pair and feature: the gated messages into dq and the three dmu
    # channels, [B, i, j, 4f]
    w = (tpn._rbf(dist, wk.shape[0], cutoff) @ wk + bk) * gate[..., None]
    wq, wr, wm = w[..., :f], w[..., f:2 * f], w[..., 2 * f:]
    msg = [wq * x[:, None, :, :f]]
    for c, dc in enumerate((dirx, diry, dirz)):
        msg.append(wr * x[:, None, :, f:2 * f] * dc[..., None]
                   + wm * x[:, None, :, 2 * f:] * mu[:, None, :, c * f:(c + 1) * f])
    pad = torch.zeros(b_n, m, m, 4 * f, dtype=x.dtype)
    pad[:, :n, :n] = torch.cat(msg, dim=-1)
    lst, _, pre = tile_list(gate, sym=False, sparse=sparse)
    n_items = b_n * nt
    got = torch.full((b_n, m, 4 * f), float("nan"), dtype=x.dtype)
    writes = torch.zeros(b_n, m, dtype=torch.int64)

    def write(item, rows):
        b, pi = divmod(item, nt)
        got[b, TILE * pi:TILE * pi + TILE] = rows
        writes[b, TILE * pi:TILE * pi + TILE] += 1

    for k in range(blocks):
        for item in range(k, n_items, blocks):
            if pre[item] == pre[item + 1]:
                write(item, torch.zeros(TILE, 4 * f, dtype=x.dtype))
        t0 = pre[first_item(pre, blocks, k)]
        t1 = pre[first_item(pre, blocks, k + 1)]
        cur, halves = None, None
        for t in range(t0, t1):
            b, pi, pj = lst[t]
            item = b * nt + pi
            if item != cur:
                if cur is not None:
                    write(cur, halves[0] + halves[1])
                cur, halves = item, [torch.zeros(TILE, 4 * f, dtype=x.dtype) for _ in range(2)]
            tile = pad[b, TILE * pi:TILE * pi + TILE, TILE * pj:TILE * pj + TILE]
            halves[0] += tile[:, :4].sum(1)
            halves[1] += tile[:, 4:].sum(1)
        if cur is not None:
            write(cur, halves[0] + halves[1])
    assert (writes == 1).all()  # every row once, by one block
    got = got[:, :n]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert not got[1].any()  # the empty slot


@pytest.mark.parametrize("blocks", [3, 50])
def test_ncsn_forward_row_partials_are_the_reference_rows_f64(blocks):
    """ncsn_fwd_kernel sums each pair's loss over the tile's columns and over
    the consecutive tiles of one row tile in its run, and writes one 8-row
    partial per (block, item) segment at slot item + block; ncsn_rows_kernel
    adds, per row, the item's segments in block order (zero where the row
    tile has no listed tile). On a batch with padding and an empty graph
    slot that is the plain version's rows."""
    n, emb, anneal = 20, 8, 2.0
    sizes = (17, 0, 12)
    dist, _, mask = _geometry(8, sizes, n)
    rng = np.random.default_rng(9)
    pm = mask[:, :, None] & mask[:, None, :]
    sel = (torch.triu(torch.ones(n, n, dtype=torch.bool), 1) & pm).double()
    noise = torch.from_numpy(rng.normal(size=dist.shape))
    sigma = torch.from_numpy(rng.uniform(0.1, 2.0, len(sizes)))
    u = torch.from_numpy(rng.normal(size=(len(sizes), n, emb)))
    weights = _head(rng, emb)
    want = tns.ncsn_score_loss_reference(dist, noise, sel, sigma, u, *weights, anneal)
    # the per-pair loss: row sums of a one-hot sel are the pairs' losses
    w_d1, b_d1, w_d2, b_d2, w_od, b_od, w2, b2, w3, b3 = weights
    used = sigma[:, None, None]
    demb = torch.relu((dist + noise * used)[..., None] * w_d1[0] + b_d1) @ w_d2 + b_d2
    l1 = torch.relu(u[:, :, None, :] + u[:, None, :, :] + demb @ w_od + b_od)
    score = (torch.relu(l1 @ w2 + b2) @ w3 + b3)[..., 0] / used
    loss = 0.5 * (score + noise / used) ** 2 * used**anneal * sel

    lst, _, pre = tile_list(sel, sym=False)
    nt = -(-n // TILE)
    pad = torch.zeros(len(sizes), nt * TILE, nt * TILE, dtype=loss.dtype)
    pad[:, :n, :n] = loss
    rpart = {}  # slot -> [8 rows]
    for k, r in enumerate(runs(len(lst), blocks)):
        for t in r:
            b, pi, pj = lst[t]
            slot = b * nt + pi + k
            tile = pad[b, TILE * pi:TILE * pi + TILE, TILE * pj:TILE * pj + TILE]
            rpart[slot] = rpart.get(slot, 0) + tile.sum(1)
    got = torch.zeros(len(sizes), nt * TILE, dtype=loss.dtype)
    for b in range(len(sizes)):
        for pi in range(nt):
            item = b * nt + pi
            s = torch.zeros(TILE, dtype=loss.dtype)
            for k in du_blocks(pre, item, blocks):
                s = s + rpart[item + k]
            got[b, TILE * pi:TILE * pi + TILE] = s
    torch.testing.assert_close(got[:, :n], want, rtol=1e-12, atol=1e-12)
    assert not got[1].any()  # the empty slot


def first_run_block(t0, total, blocks):
    """``first_run_block``: the last block whose run starts at or before
    listed tile t0."""
    return ((t0 + 1) * blocks + total - 1) // total - 1


def _max_neighbors_case(seed, sizes, n, k=6, f=16, g=8, cutoff=5.0):
    """A max_neighbors-like CFConv input in f64: each row keeps its k nearest
    in-cutoff neighbours (env not symmetric), x [B, n, f] and the filter
    weights."""
    dist, env, _ = _geometry(seed, sizes, n, cutoff)
    d = torch.where(env != 0, dist, torch.full_like(dist, float("inf")))
    kth = d.sort(-1).values[..., k - 1:k]
    env = torch.where(d <= kth, env, torch.zeros_like(env))
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.normal(size=(len(sizes), n, f)))
    w1, w2 = (torch.from_numpy(rng.normal(scale=0.3, size=s)) for s in ((g, f), (f, f)))
    b1, b2 = (torch.from_numpy(rng.normal(scale=0.3, size=f)) for _ in range(2))
    return dist, env, x, (w1, b1, w2, b2)


@pytest.mark.parametrize("blocks,sparse,stripe", [
    (1, True, None), (7, True, None), (7, False, None), (132, True, None),
    (7, True, (8, 20)), (50, True, (3, 17))])
def test_cfconv_plain_forward_equal_runs_write_each_row_once_f64(blocks, sparse, stripe):
    """cfconv_fwd_kernel's scheme on a max_neighbors graph (env not
    symmetric; with ``stripe`` the rows r0:r1 only, ni != nj): block k walks
    listed tiles [run_begin(k), run_begin(k + 1)); a row's sums are kept in
    two halves (the warps wm = 0, 1: columns jl 0-3 and 4-7) and added, half
    0 then half 1, when the run leaves its item; an item whole in the run is
    written there, the run's first and last item, where a run boundary
    splits them, go to the block's partial slots 0 and 1, and
    cfconv_fwd_join_kernel adds an item's partials in block order (block k
    takes the item of run_begin(k) at its first boundary inside it); the
    rows of items with no listed tile are written as zeros. Every row is
    written exactly once and the result is the plain version's."""
    n, g, cutoff = 20, 8, 5.0
    dist, env, x, fw = _max_neighbors_case(11, (20, 0, 11), n, g=g, cutoff=cutoff)
    if stripe is not None:
        dist, env = dist[:, stripe[0]:stripe[1]], env[:, stripe[0]:stripe[1]]
    want = tcf.cfconv_fused_reference(dist, env, x, *fw, 0.0, cutoff, g)
    b_n, ni, nj = dist.shape
    f = x.shape[-1]
    nti, ntj = -(-ni // TILE), -(-nj // TILE)
    ew = torch.zeros(b_n, nti * TILE, ntj * TILE, f, dtype=x.dtype)
    ew[:, :ni, :nj] = env[..., None] * _filter(dist, *fw, cutoff, g)
    xp = torch.zeros(b_n, ntj * TILE, f, dtype=x.dtype)
    xp[:, :nj] = x
    lst, _, pre = tile_list(env, sym=False, sparse=sparse)
    total = len(lst)
    got = torch.full((b_n, nti * TILE, f), float("nan"), dtype=x.dtype)
    writes = torch.zeros(b_n, nti * TILE, dtype=torch.int64)

    def item_of(t):
        return lst[t][0] * nti + lst[t][1]

    def write(item, rows):
        b, pi = divmod(item, nti)
        got[b, TILE * pi:TILE * pi + TILE] = rows
        writes[b, TILE * pi:TILE * pi + TILE] += 1

    part = {}
    for k in range(blocks):
        for item in range(k, b_n * nti, blocks):
            if pre[item] == pre[item + 1]:
                write(item, torch.zeros(TILE, f, dtype=x.dtype))
        t0, t1 = run_begin(total, blocks, k), run_begin(total, blocks, k + 1)
        if t0 >= t1:
            continue
        first, cur, halves = item_of(t0), None, None

        def flush():
            rows = halves[0] + halves[1]
            if pre[cur] >= t0 and pre[cur + 1] <= t1:
                write(cur, rows)
            else:
                part[k, int(cur != first)] = rows

        for t in range(t0, t1):
            b, pi, pj = lst[t]
            if b * nti + pi != cur:
                if cur is not None:
                    flush()
                cur = b * nti + pi
                halves = [torch.zeros(TILE, f, dtype=x.dtype) for _ in range(2)]
            tile = ew[b, TILE * pi:TILE * pi + TILE, TILE * pj:TILE * pj + TILE] \
                * xp[b, None, TILE * pj:TILE * pj + TILE]
            halves[0] += tile[:, :4].sum(1)
            halves[1] += tile[:, 4:].sum(1)
        flush()
    for k in range(1, blocks):
        t = run_begin(total, blocks, k)
        if t >= total:
            continue
        item = item_of(t)
        ta, tb = pre[item], pre[item + 1]
        if t == ta or run_begin(total, blocks, k - 1) > ta:
            continue
        s = torch.zeros(TILE, f, dtype=x.dtype)
        for j in range(first_run_block(ta, total, blocks), blocks):
            rb = run_begin(total, blocks, j)
            if rb >= tb:
                break
            if run_begin(total, blocks, j + 1) > rb:
                s = s + part[j, int(item_of(rb) != item)]
        write(item, s)
    assert (writes[:, :ni] == 1).all()  # every row once
    torch.testing.assert_close(got[:, :ni], want, rtol=1e-12, atol=1e-12)
    assert not got[1].any()  # the empty slot


def _painn_stack_case(seed, sizes, n, f=4, r=6, layers=3):
    """The stack's inputs in f64: the pair grids of ``_painn_case``, q0 [B,
    n, f] and the 11 weight stacks."""
    args, mask = _painn_case(seed, sizes, n, f, r)
    rng = np.random.default_rng(seed + 2)

    def w(*shape):
        return torch.from_numpy(rng.normal(scale=1.0 / np.sqrt(shape[-2]), size=shape))

    def bias(*shape):
        return torch.from_numpy(rng.normal(scale=0.3, size=shape))

    stacked = (w(layers, f, f), bias(layers, f), w(layers, f, 3 * f), bias(layers, 3 * f),
               w(layers, r, 3 * f), bias(layers, 3 * f), w(layers, f, 2 * f),
               w(layers, 2 * f, f), bias(layers, f), w(layers, f, 3 * f), bias(layers, 3 * f))
    q0 = torch.from_numpy(rng.normal(size=(len(sizes), n, f)))
    return args[:5], q0, stacked, args[-1]


@pytest.mark.parametrize("blocks,sparse,save,chunk", [
    (1, True, False, 64), (5, True, True, 32), (5, False, True, 64), (132, True, False, 32)])
def test_painn_stack_phases_are_the_reference_f64(blocks, sparse, save, chunk):
    """painn_stack_kernel's phases: dense 0 (q = q0, mu = 0, block 0's
    x-MLP) over chunks of 64 or 32 rows of [B*N, .] round-robin over the
    blocks; then
    per block k the message pass over runs of whole items (first_item), from
    x and the OLD mu into workspaces dq, dmu (each row written once, empty
    items' rows zero), and dense k + 1: per channel mu'_c = mu_c + dmu_c, v_c
    and w_c (w_c kept in the chunk's rows of the x workspace), the context
    MLP from q' = q + dq, the new q and mu, then block k + 1's x-MLP into
    the x workspace. Residuals where the kernel writes them: qs, mus at
    dense 0 and with each new q, mu; qps, mups as the mixing loads them. On
    a batch with padding and an empty graph slot that is the plain stack,
    with and without save_residuals."""
    grids, q0, stacked, cutoff = _painn_stack_case(12, (20, 0, 13), 24)
    eps = 1e-8
    want = tpn.painn_stack_reference(*grids, q0, stacked, cutoff, eps, save_residuals=save)
    wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2, b2 = stacked
    b_n, n, f = q0.shape
    layers, rows = wd1.shape[0], b_n * n
    nt = -(-n // TILE)
    m = nt * TILE
    silu = torch.nn.functional.silu

    def nan(*shape):
        return torch.full(shape, float("nan"), dtype=q0.dtype)

    q, mu = nan(rows, f), nan(rows, 3 * f)
    xw, dqw, dmuw = nan(rows, 3 * f), nan(rows, f), nan(rows, 3 * f)
    res = {k: nan(b_n, layers, n, w) for k, w in (("qs", f), ("mus", 3 * f),
                                                  ("qps", f), ("mups", 3 * f))}

    def put(name, rs, l, v):
        for r, row in zip(range(rs.start, rs.stop), v):
            res[name][r // n, l, r % n] = row

    lst, _, pre = tile_list(grids[1], sym=False, sparse=sparse)
    n_items = b_n * nt
    for l in range(layers + 1):
        done = torch.zeros(rows, dtype=torch.int64)
        for k in range(blocks):
            for ch in range(k, -(-rows // chunk), blocks):
                rs = slice(ch * chunk, min(ch * chunk + chunk, rows))
                done[rs] += 1
                if l == 0:
                    s = q0.reshape(rows, f)[rs]
                    q[rs], mu[rs] = s, 0.0
                    put("qs", rs, 0, s)
                    put("mus", rs, 0, torch.zeros(rs.stop - rs.start, 3 * f))
                else:
                    lm = l - 1
                    vn2, vw = 0.0, 0.0
                    put("mups", rs, lm, mu[rs] + dmuw[rs])  # as each channel loads
                    for c in range(3):
                        cs = slice(c * f, c * f + f)
                        mup = mu[rs, cs] + dmuw[rs, cs]
                        v, w = mup @ wmix[lm][:, :f], mup @ wmix[lm][:, f:]
                        vn2, vw = vn2 + v * v, vw + v * w
                        xw[rs, cs] = w
                    qp = q[rs] + dqw[rs]
                    put("qps", rs, lm, qp)
                    h = silu(qp @ w1[lm][:f] + torch.sqrt(vn2 + eps) @ w1[lm][f:] + b1[lm])
                    s = (qp + (h @ w2[lm][:, :f] + b2[lm][:f])) \
                        + (h @ w2[lm][:, 2 * f:] + b2[lm][2 * f:]) * vw
                    q[rs] = s
                    gv = h @ w2[lm][:, f:2 * f] + b2[lm][f:2 * f]
                    mu[rs] = torch.cat([(mu[rs, c * f:c * f + f] + dmuw[rs, c * f:c * f + f])
                                        + gv * xw[rs, c * f:c * f + f] for c in range(3)], -1)
                    if l < layers:
                        put("qs", rs, l, q[rs])
                        put("mus", rs, l, mu[rs])
                if l < layers:
                    xw[rs] = silu(s @ wd1[l] + bd1[l]) @ wd2[l] + bd2[l]
        assert (done == 1).all()  # every row once per dense phase
        if l == layers:
            break
        # the message pass of block l from x and the OLD mu, rows written once
        dqw[:], dmuw[:] = float("nan"), float("nan")
        msg = torch.zeros(b_n, m, m, 4 * f, dtype=q0.dtype)
        dq, dmu = tpn.painn_message_reference(*grids, xw.view(b_n, n, 3 * f),
                                              mu.view(b_n, n, 3 * f), wk[l], bk[l], cutoff)
        # per pair: the reference's messages split by pair (dq, dmu are their sums)
        w3 = (tpn._rbf(grids[0], wk.shape[1], cutoff) @ wk[l] + bk[l]) * grids[1][..., None]
        xv, muv = xw.view(b_n, n, 3 * f), mu.view(b_n, n, 3 * f)
        wx = w3 * xv[:, None]
        parts = [wx[..., :f]] + [wx[..., f:2 * f] * dc[..., None]
                                 + wx[..., 2 * f:] * muv[:, None, :, c * f:c * f + f]
                                 for c, dc in enumerate(grids[2:])]
        msg[:, :n, :n] = torch.cat(parts, -1)
        torch.testing.assert_close(msg.sum(2)[:, :n], torch.cat([dq, dmu], -1),
                                   rtol=1e-12, atol=1e-12)
        for k in range(blocks):
            for item in range(k, n_items, blocks):
                if pre[item] == pre[item + 1]:
                    b, pi = divmod(item, nt)
                    for i in range(TILE * pi, min(TILE * pi + TILE, n)):
                        dqw[b * n + i], dmuw[b * n + i] = 0.0, 0.0
            cur, acc = None, None

            def flush():
                b, pi = divmod(cur, nt)
                for i in range(TILE * pi, min(TILE * pi + TILE, n)):
                    assert torch.isnan(dqw[b * n + i]).all()  # written once
                    dqw[b * n + i] = acc[i - TILE * pi, :f]
                    dmuw[b * n + i] = acc[i - TILE * pi, f:]

            for t in range(pre[first_item(pre, blocks, k)], pre[first_item(pre, blocks, k + 1)]):
                b, pi, pj = lst[t]
                if b * nt + pi != cur:
                    if cur is not None:
                        flush()
                    cur, acc = b * nt + pi, torch.zeros(TILE, 4 * f, dtype=q0.dtype)
                acc += msg[b, TILE * pi:TILE * pi + TILE, TILE * pj:TILE * pj + TILE].sum(1)
            if cur is not None:
                flush()
        assert not torch.isnan(dqw).any() and not torch.isnan(dmuw).any()
    got = (q.view(b_n, n, f), mu.view(b_n, n, 3 * f))
    if save:
        got = got + tuple(res[k] for k in ("qs", "mus", "qps", "mups"))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)
