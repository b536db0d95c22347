"""Probe of the CFConv kernels' bf16 instances against their f32 instances
and their plain versions, on the card (PR 20's first chip call).

    env PYTHONPATH=. python geossl_tpu_torch/utils/probe_bf16.py

Builds the kernels, prints the card's name and power limit and each CFConv
instance's ptxas registers and spills, then at G = 51 and 300, on seeded
random molecules (B=32, N=128 with a max_neighbors=32 graph and with the
radius graph; B=8, N=512), each forward and backward in f32 and in bf16
against its plain version (max error over the output's largest magnitude,
relative norm; gating off and on) and its ms over 10 launches after two.
"""
import re
import subprocess
import time

import torch

from geossl_tpu_torch.models.common import cosine_envelope
from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops import cfconv as K
from geossl_tpu_torch.ops import geometry


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    t0 = time.time()
    _build.build_all()
    print("build s", time.time() - t0)
    for lib in ("cfconv_fwd", "cfconv_bwd"):
        log = _build.build_log(lib)
        cur = None
        for line in log.splitlines():
            m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
            if m:
                cur = m.group(1)
                continue
            if cur and ("registers" in line or "spill" in line) and "kernel" in cur and "join" not in cur:
                print(lib, cur[:60], line.strip()[:120])
    K.plain_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def case(b, n, kmax=None, fill=0.7):
        pos = torch.randn((b, n, 3), generator=gen, device=dev) * (n ** (1 / 3)) * 0.9
        mask = torch.arange(n, device=dev)[None, :] < (fill * n)
        mask = mask.expand(b, n).clone()
        dist, pm = geometry.pairwise_distances(pos, mask)
        adj = geometry.radius_adjacency(dist, pm, 10.0, kmax)
        env = (cosine_envelope(dist, 10.0) * adj.float()).contiguous()
        x = torch.randn((b, n, 128), generator=gen, device=dev)
        g = torch.randn((b, n, 128), generator=gen, device=dev) * mask[..., None]
        return dist.contiguous(), env, x, g

    def weights(G):
        w1 = torch.randn((G, 128), generator=gen, device=dev) * (6 / (G + 128)) ** 0.5
        w2 = torch.randn((128, 128), generator=gen, device=dev) * (6 / 256) ** 0.5
        b1 = torch.randn((128,), generator=gen, device=dev) * 0.1
        b2 = torch.randn((128,), generator=gen, device=dev) * 0.1
        return [w1, b1, w2, b2]

    def err(a, w):
        sc = w.abs().max().item()
        return (a - w).abs().max().item() / max(sc, 1e-30), ((a - w).norm() / w.norm()).item()

    def tm(fn, reps=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    NAMES = ("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2")
    for G in (51, 300):
        fw = weights(G)
        a = (0.0, 10.0, G)
        for label, (d, e, x, g), sym in (("mn32 B=32 N=128", case(32, 128, 32), False), ("sym B=32 N=128", case(32, 128), True), ("sym B=8 N=512", case(8, 512), True)):
            fwd = K.cfconv_fused_sym if sym else K.cfconv_fused
            bwd = K.cfconv_bwd_sym if sym else K.cfconv_bwd
            with torch.no_grad():
                for mxu in ("f32", "bf16"):
                    want = K.cfconv_fused_reference(d, e, x, *fw, *a, mxu)
                    for sp in (False, True):
                        got = fwd(d, e, x, *fw, *a, sp, mxu)
                        print(f"G={G} {label} fwd {mxu} sp={sp}: maxrel {err(got, want)[0]:.2e} relnorm {err(got, want)[1]:.2e}")
                    if mxu == "bf16":
                        w32 = K.cfconv_fused_reference(d, e, x, *fw, *a)
                        print(f"   bf16 plain vs f32 plain: {err(want, w32)}")
                    ms = tm(lambda: fwd(d, e, x, *fw, *a, True, mxu))
                    print(f"   fwd {mxu} ms {ms:.3f}")
                for mxu in ("f32", "bf16"):
                    want = K.cfconv_bwd_reference(d, e, x, g, *fw, *a, mxu)
                    if sym:
                        want = (*(K.place_sym_cotangent(t) for t in want[:2]), *want[2:])
                    for sp in (False, True):
                        got = bwd(d, e, x, g, *fw, *a, sp, mxu)
                        for nm, u, w in zip(NAMES, got, want):
                            if sp and nm in ("ddist", "denv"):
                                continue
                            r = err(u, w)
                            print(f"G={G} {label} bwd {mxu} sp={sp} {nm}: maxrel {r[0]:.2e} relnorm {r[1]:.2e}")
                    ms = tm(lambda: bwd(d, e, x, g, *fw, *a, True, mxu))
                    print(f"   bwd {mxu} ms {ms:.3f}")
    print("ok")


if __name__ == "__main__":
    main()
