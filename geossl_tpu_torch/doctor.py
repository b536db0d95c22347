"""Environment health check: ``python -m geossl_tpu_torch doctor``
(counterpart of ``geossl_tpu/doctor.py``).

Diagnoses what goes wrong in a deployment of the port before a long run is
started against it:

- backend: torch and CUDA versions, the visible cards, and the card's name
  and power limit (``nvidia-smi``). With no card visible this fails, unless
  ``--device cpu`` asks for the CPU: nothing runs on the CPU unasked;
- build: ``nvcc`` and its version, whether ``ops/_build/`` is writable, and
  ``ops/_build.build_all()`` of every kernel source (the counterpart of the
  JAX doctor's compile cache);
- dispatch: a 256x256 product on the device, the first call's seconds and
  the steady ms per call, fenced once by a value fetch (``.item()``) and
  once by ``torch.cuda.synchronize()`` (``fence_reliable``: the two agree
  within 3x);
- native: the C++ host runtime builds and loads (``radius_edges`` smoke);
- kernels: on the card, one launch of every kernel of ``ops/csrc`` (both
  modes where a source has two; the CFConv kernels also in their bf16
  instances, counted as ``<kernel>_bf16``) at a tiny shape with real
  geometry, padding and empty tiles, each held to its plain version with
  the tolerances of ``chip_smoke.py`` (the bf16 instances with phase 6's);
  each kernel's launch counter must move.
  With ``--device cpu`` nothing is launched and nothing is reported as
  checked: the plain versions are not the kernels;
- ``--mesh N``: N gloo ranks on the CPU, in fresh processes, run one
  ``all_reduce`` and check its sum.

Exit code 0 when every check passes, 1 otherwise; ``[warn]`` does not fail.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import torch

# the tolerances of chip_smoke.py: elementwise rtol RTOL and atol ATOL
# times the output's largest magnitude; weight gradients by relative
# Frobenius norm, all together GRAD_RTOL and each tensor 10x that
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-3
# the CFConv kernels' bf16 instances (mxu='bf16') against their plain bf16
# versions, chip_smoke.py's phase 6: the JAX package's own bound for the
# mode (tests/test_cfconv_pallas.py's test_bf16_mxu_mode): outputs
# elementwise within rtol BF16_RTOL and atol BF16_ATOL times max|plain|;
# each gradient's mean |kernel - plain| within BF16_GRAD_MEAN of the mean
# |f32 plain gradient|, and, tighter, its relative norm within
# BF16_GRAD_NORM (the symmetric backward rounds a cell's qe with its
# mirror's added, the plain version each cell's own: ~3e-3 apart)
BF16_RTOL = BF16_ATOL = 2e-3
BF16_GRAD_MEAN = 0.05
BF16_GRAD_NORM = 1e-2
# the tiny case: graphs of these sizes in B slots of N atoms (the last slot
# is padding); the second graph is spread out, so that it has empty tiles
SIZES, B, N = (40, 23, 9), 4, 64
# SchNet's Gaussian counts, with the suffix of their case keys: the
# published 51, and 100, above the 64 where the CFConv kernels stream W1
SCHNET_G = ((51, ""), (100, "100"))
SEED = 0


def _p(status: str, name: str, detail: str = "") -> None:
    print(f"[{status}] {name}" + (f": {detail}" if detail else ""), flush=True)


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else \
        f"nvidia-smi failed ({r.returncode})"


def check_backend(results: dict, device: torch.device) -> bool:
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "cuda_available": torch.cuda.is_available(),
            "n_devices": torch.cuda.device_count() if
            torch.cuda.is_available() else 0}
    if device.type == "cuda":
        if not info["cuda_available"]:
            _p("fail", "backend", f"torch {info['torch']} sees no CUDA device "
               "(pass --device cpu to check the CPU)")
            results["backend"] = {"ok": False, "platform": "none", **info}
            return False
        info["kind"] = torch.cuda.get_device_name(device)
        info["card"] = _card()
        _p("ok", "backend", f"platform=cuda devices={info['n_devices']} "
           f"({info['kind']}; {info['card']}) torch {info['torch']} "
           f"CUDA {info['cuda']}")
    else:
        _p("ok", "backend", f"platform=cpu (--device cpu) torch "
           f"{info['torch']}; {info['n_devices']} CUDA device(s) visible")
    results["backend"] = {"ok": True, "platform": device.type, **info}
    return True


def check_build(results: dict, device: torch.device) -> bool:
    """nvcc, a writable build directory, and every kernel source built."""
    from geossl_tpu_torch.ops import _build

    miss = "fail" if device.type == "cuda" else "warn"
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        _p(miss, "build", str(e))
        results["build"] = {"ok": miss == "warn", "nvcc": None}
        return miss == "warn"
    r = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       timeout=60)
    version = (r.stdout.strip().splitlines() or ["?"])[-1]
    try:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        probe = os.path.join(_build.BUILD_DIR, f".doctor_probe{os.getpid()}")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        _p("fail", "build", f"{_build.BUILD_DIR} not writable: {e}")
        results["build"] = {"ok": False, "nvcc": nvcc, "writable": False}
        return False
    current = [n for n in _build.SOURCES
               if os.path.exists(_build.lib_path(n))]
    t0 = time.time()
    try:
        built = sorted(_build.build_all())
    except RuntimeError as e:
        _p("fail", "build", str(e).splitlines()[0])
        results["build"] = {"ok": False, "nvcc": nvcc, "error": str(e)}
        return False
    seconds = time.time() - t0
    _p("ok", "build", f"{nvcc} ({version}); {_build.BUILD_DIR} writable; "
       f"built {built or 'nothing'} in {seconds:.1f} s, "
       f"{len(current)} of {len(_build.SOURCES)} were current")
    results["build"] = {"ok": True, "nvcc": nvcc, "version": version,
                        "writable": True, "seconds": round(seconds, 2),
                        "built": built, "current_before": current}
    return True


def check_dispatch(results: dict, device: torch.device,
                   budget_s: float) -> bool:
    """First call and steady latency of a small product, two fences."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def f(x):
        return (x @ x).sum()

    x = torch.ones((256, 256), dtype=torch.float32, device=device)
    t0 = time.time()
    try:
        f(x).item()
    except Exception as e:  # a broken driver or card
        _p("fail", "dispatch", f"first call raised: {e}")
        results["dispatch"] = {"ok": False, "error": str(e)}
        return False
    t_first = time.time() - t0
    if t_first > budget_s:
        _p("warn", "dispatch", f"first call took {t_first:.1f}s")
    n = 10
    t0 = time.time()
    for _ in range(n):
        out = f(x)
    fetched = out.item()
    per_fetched = (time.time() - t0) / n
    t0 = time.time()
    for _ in range(n):
        out = f(x)
    sync()
    per_synced = (time.time() - t0) / n
    ratio = per_fetched / max(per_synced, 1e-9)
    detail = (f"first={t_first:.2f}s steady={per_fetched * 1e3:.3f}ms/call "
              f"(synchronize reads {per_synced * 1e3:.3f}ms)")
    if ratio > 3.0:
        _p("warn", "dispatch", detail + ": synchronize() is not a reliable "
           "fence here; time with value fetches")
    else:
        _p("ok", "dispatch", detail)
    results["dispatch"] = {
        "ok": True, "first_s": round(t_first, 3),
        "steady_ms": round(per_fetched * 1e3, 4),
        "synced_ms": round(per_synced * 1e3, 4),
        "fence_reliable": ratio <= 3.0, "value": fetched}
    return True


def check_native(results: dict) -> bool:
    import numpy as np

    from geossl_tpu_torch.native import packing

    if not packing.enabled():
        _p("warn", "native runtime", "GEOSSL_NO_NATIVE is set: the NumPy "
           "packing paths are in use (correct, slower)")
        results["native"] = {"ok": True, "available": False}
        return True
    try:
        packing.load()
    except (RuntimeError, OSError) as e:
        _p("warn", "native runtime", "the C++ packer did not build or load "
           f"(g++ is needed); the NumPy paths need GEOSSL_NO_NATIVE=1: "
           f"{str(e).splitlines()[0]}")
        results["native"] = {"ok": True, "available": False, "error": str(e)}
        return True
    pos = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float64)
    edges = packing.radius_edges(pos, 3.0)
    _p("ok", "native runtime",
       f"built and loaded; radius_edges smoke -> {len(edges)} edges")
    results["native"] = {"ok": True, "available": True}
    return True


# -- kernels ------------------------------------------------------------------


def tile_occupied(grid, tile: int = 8):
    """[B,N,N] bool: the cell lies in an 8x8 tile with a nonzero entry."""
    import torch.nn.functional as F

    b, n, m = grid.shape
    nz = F.pad((grid != 0).float(), (0, -m % tile, 0, -n % tile))
    occ = nz.view(b, nz.shape[1] // tile, tile, nz.shape[2] // tile, tile)
    occ = occ.amax(dim=(2, 4)) > 0
    return occ.repeat_interleave(tile, 1).repeat_interleave(tile, 2)[:, :n, :m]


class Tally:
    """Each kernel's comparisons with its plain version: the largest
    |kernel - plain|, the largest relative norm, and the failures."""

    def __init__(self):
        self.rows: dict = {}

    def _row(self, name):
        return self.rows.setdefault(name, {
            "max_abs_err": 0.0, "max_rel_norm": 0.0, "checks": 0,
            "failures": []})

    def _note(self, name, got, want, what):
        row = self._row(name)
        row["checks"] += 1
        if got.shape != want.shape or not torch.isfinite(got).all():
            row["failures"].append(f"{what}: shape {tuple(got.shape)} vs "
                                   f"{tuple(want.shape)} or non-finite")
            return None
        err = (got - want).abs().max().item() if got.numel() else 0.0
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return row

    def scaled(self, name, got, want, what):
        """Elementwise: rtol RTOL, atol ATOL times max|want|."""
        row = self._note(name, got, want, what)
        if row is None:
            return
        atol = ATOL * max(1.0, want.abs().max().item() if want.numel() else 0.0)
        if not (got - want).abs().le(atol + RTOL * want.abs()).all():
            row["failures"].append(
                f"{what}: max_abs_err {(got - want).abs().max().item():.3e} "
                f"beyond rtol {RTOL} atol {atol:.3e}")

    def norm(self, name, got, want, what, tol=GRAD_RTOL):
        """Relative Frobenius norm (sums over pairs that cancel)."""
        row = self._note(name, got, want, what)
        if row is None:
            return
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        row["max_rel_norm"] = max(row["max_rel_norm"], rel)
        if rel > tol:
            row["failures"].append(f"{what}: relative error {rel:.3e} beyond "
                                   f"{tol}")

    def weights(self, name, got, want, what):
        """Weight gradients: each by 10x GRAD_RTOL, all by GRAD_RTOL."""
        for k, (a, w) in enumerate(zip(got, want)):
            self.norm(name, a, w, f"{what} weight gradient {k}",
                      10 * GRAD_RTOL)
        self.norm(name, torch.cat([a.flatten() for a in got]),
                  torch.cat([w.flatten() for w in want]),
                  f"{what} all weight gradients")

    def bf16_scaled(self, name, got, want, what):
        """A bf16 instance's output: rtol BF16_RTOL, atol BF16_ATOL times
        max|want|."""
        row = self._note(name, got, want, what)
        if row is None:
            return
        atol = BF16_ATOL * (want.abs().max().item() if want.numel() else 0.0)
        if not (got - want).abs().le(atol + BF16_RTOL * want.abs()).all():
            row["failures"].append(
                f"{what}: max_abs_err {(got - want).abs().max().item():.3e} "
                f"beyond rtol {BF16_RTOL} atol {atol:.3e}")

    def bf16_grad(self, name, got, want, want_f32, what):
        """A bf16 instance's gradient: mean |got - want| within
        BF16_GRAD_MEAN of mean |want_f32|, relative norm within
        BF16_GRAD_NORM."""
        row = self._note(name, got, want, what)
        if row is None:
            return
        mean = (got - want).abs().mean().item()
        scale = want_f32.abs().mean().item() + 1e-30
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        row["max_rel_norm"] = max(row["max_rel_norm"], rel)
        if mean > BF16_GRAD_MEAN * scale or rel > BF16_GRAD_NORM:
            row["failures"].append(
                f"{what}: mean_abs_err {mean:.3e} (f32 mean {scale:.3e}), "
                f"rel_norm {rel:.3e} beyond {BF16_GRAD_MEAN} / "
                f"{BF16_GRAD_NORM}")

    def failed(self, name, what, error):
        self._row(name)["failures"].append(f"{what}: {error}")


def _case(device: torch.device):
    """The tiny batch at full kernel width: SchNet (F=128, G=51, 2 blocks)
    on its symmetric radius graph and on a max_neighbors=8 graph, the same
    at G=100 (the kernels' instances that stream W1, above 64), PaiNN
    (F=128, R=20, 2 blocks), and an NCSN head (E=128) with seeded draws."""
    from dataclasses import replace

    import numpy as np

    from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
    from geossl_tpu_torch.data.bucketing import pack_batch
    from geossl_tpu_torch.data.synthetic import _random_molecule
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.ops.geometry import pairwise_distances
    from geossl_tpu_torch.train.common import make_backbone

    rng = np.random.default_rng(SEED)
    records = [_random_molecule(rng, n) for n in SIZES]
    records[1].positions = records[1].positions * 3.0
    batch = pack_batch(records, N, B).to(device)
    cfg = ModelConfig(schnet=SchNetConfig(num_interactions=2))
    cfg_p = ModelConfig(model_3d="painn",
                        painn=PaiNNConfig(n_interactions=2))
    gen = torch.Generator().manual_seed(SEED)
    case = {}
    with torch.no_grad():
        runs = [(tag + g_tag, replace(c, schnet=replace(c.schnet,
                                                         num_gaussians=g)))
                for g, g_tag in SCHNET_G
                for tag, c in (("sym", cfg), ("mn", replace(cfg, max_neighbors=8)))]
        for tag, c in runs:
            m = make_backbone(c, torch.Generator().manual_seed(SEED)).to(device)
            dist, adj = m.geometry(batch.positions, batch.node_mask)
            env = m.envelope(dist, adj)
            h0 = m.embedding(batch.atom_type)
            case[tag] = dict(
                dist=dist.contiguous(), env=env.contiguous(),
                h0=h0.contiguous(),
                x=m.interactions[0].conv.lin1(h0).contiguous(),
                fw=[t.contiguous() for t in m.interactions[0].filter_weights()],
                stacked=m.stacked_weights(), G=m.num_gaussians,
                cutoff=m.cutoff)
        mp = make_backbone(cfg_p, torch.Generator().manual_seed(SEED)).to(device)
        dist, direction, gate = mp.geometry(batch.positions, batch.node_mask)
        q0 = mp.embed(batch.atom_type).contiguous()
        wk, bk = mp.filter_weights()[0]
        case["painn"] = dict(
            grids=(dist.contiguous(), gate.contiguous(),
                   *(direction[..., k].contiguous() for k in range(3))),
            q0=q0, x=mp.interactions[0].interatomic_context_net(q0).contiguous(),
            mu=torch.randn((B, N, 3 * 128), generator=gen).to(device),
            wk=wk.contiguous(), bk=bk.contiguous(),
            stacked=mp.stacked_weights(), cutoff=cfg_p.painn.cutoff)
        d2, live = pairwise_distances(batch.positions, batch.node_mask)
        sel = (live & (torch.rand(d2.shape, generator=gen).to(device) < 0.3))
        weights = [torch.randn(s, generator=gen).to(device)
                   / max(1, s[0]) ** 0.5 for s in NS.weight_shapes(128)]
        case["ncsn"] = dict(
            grid=(d2.contiguous(),
                  torch.randn(d2.shape, generator=gen).to(device),
                  sel.float().contiguous(),
                  torch.tensor([0.01, 0.3, 10.0, 1.0]).to(device),
                  torch.randn((B, N, 128), generator=gen).to(device)),
            weights=weights, anneal=2.0)
    case["g"] = torch.randn((B, N, 128), generator=gen).to(device)
    case["gmu"] = torch.randn((B, N, 3 * 128), generator=gen).to(device)
    case["g_rows"] = torch.randn((B, N), generator=gen).to(device)
    return case


def _masked(want, occ):
    return torch.where(occ, want, torch.zeros_like(want))


def run_kernel_checks(device: torch.device) -> dict:
    """Every kernel wrapper of ``ops/`` on the tiny case, gating off and on,
    held to its plain version. Returns ``{kernel: row}`` with each row's
    comparisons and ``launches``, the kernel's launch count in these
    checks: on CPU tensors the wrappers take their plain versions, so every
    count stays 0 there."""
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts

    before = launch_counts()
    case = _case(device)
    tally = Tally()

    def guarded(name, what, fn):
        try:
            fn()
        except Exception as e:  # a launch or build failure is the finding
            tally.failed(name, what, f"{type(e).__name__}: {e}")

    # SchNet: the plain-mode pair on the truncated graph, the symmetric pair
    # on the radius graph, the stack in both modes; at both G
    for (name, bwd_name, tag, fwd, bwd), (_, g_tag) in itertools.product((
            ("cfconv_fwd", "cfconv_bwd", "mn", K.cfconv_fused, K.cfconv_bwd),
            ("cfconv_fwd_sym", "cfconv_bwd_sym", "sym", K.cfconv_fused_sym,
             K.cfconv_bwd_sym)), SCHNET_G):
        c = case[tag + g_tag]
        gw = f"G={c['G']} "
        args = (0.0, c["cutoff"], c["G"])
        ins = (c["dist"], c["env"], c["x"])
        occ = tile_occupied(c["env"])
        with torch.no_grad():
            want = K.cfconv_fused_reference(*ins, *c["fw"], *args)
        want_b = list(K.cfconv_bwd_reference(*ins, case["g"], *c["fw"], *args))
        if tag == "sym":
            want_b[:2] = [K.place_sym_cotangent(w) for w in want_b[:2]]
        for sp in (False, True):
            def fwd_check(sp=sp):
                with torch.no_grad():
                    tally.scaled(name, fwd(*ins, *c["fw"], *args, sp), want,
                                 f"{gw}sparse={sp}")

            def bwd_check(sp=sp):
                got = bwd(*ins, case["g"], *c["fw"], *args, sp)
                for k, what in enumerate(("ddist", "denv", "dx")):
                    # with gating the pair cotangents are zero on empty
                    # tiles (the occupancy contract)
                    w = _masked(want_b[k], occ) if sp and k < 2 else want_b[k]
                    tally.scaled(bwd_name, got[k], w, f"{gw}sparse={sp} {what}")
                tally.weights(bwd_name, got[3:], want_b[3:], f"{gw}sparse={sp}")

            guarded(name, f"{gw}sparse={sp}", fwd_check)
            guarded(bwd_name, f"{gw}sparse={sp}", bwd_check)
    # the same pairs' bf16 instances (counted as <kernel>_bf16), at both G
    for (name, bwd_name, tag, fwd, bwd), (_, g_tag) in itertools.product((
            ("cfconv_fwd", "cfconv_bwd", "mn", K.cfconv_fused, K.cfconv_bwd),
            ("cfconv_fwd_sym", "cfconv_bwd_sym", "sym", K.cfconv_fused_sym,
             K.cfconv_bwd_sym)), SCHNET_G):
        c = case[tag + g_tag]
        gw = f"G={c['G']} bf16 "
        args = (0.0, c["cutoff"], c["G"])
        ins = (c["dist"], c["env"], c["x"])
        occ = tile_occupied(c["env"])
        with torch.no_grad():
            want = K.cfconv_fused_reference(*ins, *c["fw"], *args, "bf16")
        want_b = list(K.cfconv_bwd_reference(*ins, case["g"], *c["fw"], *args,
                                             "bf16"))
        f32_b = list(K.cfconv_bwd_reference(*ins, case["g"], *c["fw"], *args))
        if tag == "sym":
            for w in (want_b, f32_b):
                w[:2] = [K.place_sym_cotangent(t) for t in w[:2]]
        for sp in (False, True):
            def fwd_check(sp=sp, name=name + "_bf16"):
                with torch.no_grad():
                    tally.bf16_scaled(name, fwd(*ins, *c["fw"], *args, sp,
                                                "bf16"), want,
                                      f"{gw}sparse={sp}")

            def bwd_check(sp=sp, name=bwd_name + "_bf16"):
                got = bwd(*ins, case["g"], *c["fw"], *args, sp, "bf16")
                for k, what in enumerate(("ddist", "denv", "dx", "dW1", "db1",
                                          "dW2", "db2")):
                    w, w32 = want_b[k], f32_b[k]
                    if sp and k < 2:
                        w, w32 = _masked(w, occ), _masked(w32, occ)
                    tally.bf16_grad(name, got[k], w, w32,
                                    f"{gw}sparse={sp} {what}")

            guarded(name + "_bf16", f"{gw}sparse={sp}", fwd_check)
            guarded(bwd_name + "_bf16", f"{gw}sparse={sp}", bwd_check)
    for (tag, sym), (_, g_tag) in itertools.product(
            (("sym", True), ("mn", False)), SCHNET_G):
        c = case[tag + g_tag]
        gw = f"G={c['G']} "

        def stack_check(c=c, sym=sym):
            with torch.no_grad():
                want = K.schnet_stack_reference(
                    c["dist"], c["env"], c["h0"], c["stacked"], 0.0,
                    c["cutoff"], c["G"])
                got = K.schnet_stack(c["dist"], c["env"], c["h0"],
                                     c["stacked"], 0.0, c["cutoff"], c["G"],
                                     sym)
            tally.scaled("schnet_stack", got, want, f"{gw}symmetric={sym}")

        guarded("schnet_stack", f"{gw}symmetric={sym}", stack_check)

    # the NCSN head, forward and backward
    n = case["ncsn"]

    def ncsn_fwd_check():
        with torch.no_grad():
            want_rows = NS.ncsn_score_loss_reference(*n["grid"], *n["weights"],
                                                     n["anneal"])
            got_rows = NS.ncsn_score_fwd(*n["grid"], *n["weights"],
                                         anneal=n["anneal"])
        tally.scaled("ncsn_score_fwd", got_rows, want_rows, "rows")

    def ncsn_bwd_check():
        want = NS.ncsn_score_bwd_reference(*n["grid"], case["g_rows"],
                                           *n["weights"], anneal=n["anneal"])
        got = NS.ncsn_score_bwd(*n["grid"], case["g_rows"], *n["weights"],
                                anneal=n["anneal"])
        tally.norm("ncsn_score_bwd", got[0], want[0], "du")
        tally.weights("ncsn_score_bwd", got[1:], want[1:], "head")

    guarded("ncsn_score_fwd", "rows", ncsn_fwd_check)
    guarded("ncsn_score_bwd", "du and weights", ncsn_bwd_check)

    # PaiNN: both message pairs (the symmetric pair on the radius graph's
    # symmetric grids), the stack for inference and for training
    p = case["painn"]
    ins = (*p["grids"], p["x"], p["mu"], p["wk"], p["bk"])
    occ = tile_occupied(p["grids"][1])
    with torch.no_grad():
        want = P.painn_message_reference(*ins, p["cutoff"])
    want_b = P.painn_bwd_reference(*ins, case["g"], case["gmu"], p["cutoff"])
    for name, bwd_name, fwd, bwd, sym in (
            ("painn_fwd", "painn_bwd", P.painn_message_fused, P.painn_bwd,
             False),
            ("painn_fwd_sym", "painn_bwd_sym", P.painn_message_fused_sym,
             P.painn_bwd_sym, True)):
        ref = list(want_b)
        if sym:
            ref[:5] = [K.place_sym_cotangent(w, antisymmetric=k >= 2)
                       for k, w in enumerate(ref[:5])]
        for sp in (False, True):
            def fwd_check(sp=sp, fwd=fwd, name=name):
                with torch.no_grad():
                    got = fwd(*ins, p["cutoff"], sp)
                for what, a, w in zip(("dq", "dmu"), got, want):
                    tally.scaled(name, a, w, f"sparse={sp} {what}")

            def bwd_check(sp=sp, bwd=bwd, bwd_name=bwd_name, ref=ref):
                got = bwd(*ins, case["g"], case["gmu"], p["cutoff"], sp)
                for k, what in enumerate(("ddist", "dgate", "ddirx", "ddiry",
                                          "ddirz", "dx", "dmu")):
                    w = _masked(ref[k], occ) if sp and k < 5 else ref[k]
                    tally.scaled(bwd_name, got[k], w, f"sparse={sp} {what}")
                tally.weights(bwd_name, got[7:], ref[7:], f"sparse={sp}")

            guarded(name, f"sparse={sp}", fwd_check)
            guarded(bwd_name, f"sparse={sp}", bwd_check)
    pair = p["grids"]

    def stack_infer_check():
        with torch.no_grad():
            want_s = P.painn_stack_reference(*pair, p["q0"], p["stacked"],
                                             p["cutoff"])
            got = P.painn_stack_infer(*pair, p["q0"], p["stacked"],
                                      p["cutoff"])
        for what, a, w in zip(("q", "mu"), got, want_s):
            tally.scaled("painn_stack", a, w, what)

    def stack_train_check():
        with torch.no_grad():
            want_s = P.painn_stack_reference(*pair, p["q0"], p["stacked"],
                                             p["cutoff"])
            got = P.painn_stack_train(*pair, p["q0"], p["stacked"],
                                      p["cutoff"])
        for what, a, w in zip(("q", "mu"), got, want_s):
            tally.scaled("painn_stack_train", a, w, what)

    guarded("painn_stack", "inference", stack_infer_check)
    guarded("painn_stack_train", "save_residuals", stack_train_check)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = launch_counts()
    for name in after:
        tally._row(name)["launches"] = after[name] - before.get(name, 0)
    return tally.rows


def check_kernels(results: dict, device: torch.device) -> bool:
    """On the card: every kernel launched and within tolerance."""
    if device.type != "cuda":
        _p("skip", "cuda kernels", "--device cpu")
        results["kernels"] = {"ok": True, "mode": "not run (--device cpu)",
                              "checked": []}
        return True
    from geossl_tpu_torch.ops import cfconv as K

    K.plain_precision()  # the plain versions in full f32, as the kernels
    t0 = time.time()
    rows = run_kernel_checks(device)
    ok, checked = True, []
    for name, row in rows.items():
        bad = list(row["failures"])
        if row["launches"] < 1:
            bad.append("never launched (a plain version ran)")
        good = not bad
        ok &= good
        checked.append({"name": name, "launches": row["launches"],
                        "checks": row["checks"],
                        "max_abs_err": row["max_abs_err"],
                        "max_rel_norm": row["max_rel_norm"], "ok": good,
                        "failures": bad})
        _p("ok" if good else "fail", f"kernel {name}",
           f"{row['launches']} launches, {row['checks']} comparisons, "
           f"max_abs_err {row['max_abs_err']:.2e}"
           + ("" if good else f"; {bad[0]}"))
    worst = max((c["max_abs_err"] for c in checked), default=0.0)
    _p("ok" if ok else "fail", "cuda kernels",
       f"{sum(c['ok'] for c in checked)} of {len(checked)} within tolerance "
       f"in {time.time() - t0:.1f} s (worst max_abs_err {worst:.2e})")
    results["kernels"] = {"ok": ok, "mode": "cuda", "checked": checked,
                          "seconds": round(time.time() - t0, 2)}
    return ok


# -- mesh -----------------------------------------------------------------------

_RANK_CODE = """
import sys
from datetime import timedelta
import torch
import torch.distributed as dist
rank, world, port = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=timedelta(seconds=120))
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
print(float(t))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_mesh(results: dict, n: int) -> bool:
    """N gloo ranks on the CPU in fresh processes: one all_reduce."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, str(r),
                               str(n), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs, ok = [], True
    t0 = time.time()
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            outs.append(out.strip())
            if proc.returncode != 0:
                ok = False
                outs[-1] = (err.strip().splitlines() or ["failed"])[-1]
    except subprocess.TimeoutExpired:
        ok = False
        outs.append("timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want = float(n * (n + 1) // 2)
    sums = []
    for o in outs:
        try:
            sums.append(float(o))
        except ValueError:
            sums.append(None)
    ok = ok and len(sums) == n and all(s == want for s in sums)
    _p("ok" if ok else "fail", f"gloo mesh ({n})",
       f"all_reduce sums {outs} (want {want}) in {time.time() - t0:.1f} s")
    results["mesh"] = {"ok": ok, "n": n, "sums": sums}
    return ok


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m geossl_tpu_torch doctor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: cpu checks the host only "
                        "and launches no kernel")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="also run an all_reduce over N gloo ranks on the "
                        "CPU in fresh processes (0 = skip)")
    p.add_argument("--first_call_budget", type=float, default=60.0,
                   help="seconds before the first call on the device is "
                        "flagged slow (default 60)")
    p.add_argument("--json", action="store_true",
                   help="print a machine-readable JSON summary line last")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {args.device}: cuda or cpu")
    results: dict = {}
    ok = check_backend(results, device)
    if ok:
        ok &= check_build(results, device)
        ok &= check_dispatch(results, device, args.first_call_budget)
        ok &= check_kernels(results, device)
    ok &= check_native(results)
    if args.mesh:
        ok &= check_mesh(results, args.mesh)
    print("doctor:", "all checks passed" if ok else "FAILURES above",
          flush=True)
    if args.json:
        print(json.dumps({"ok": bool(ok), **results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
