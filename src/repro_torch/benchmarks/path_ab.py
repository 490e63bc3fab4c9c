"""Step and call times of the port's main paths for two trees of this
repository, measured in turn on one card, so that a change can be held
against its parent in one run:

    python src/repro_torch/benchmarks/path_ab.py --trees OLD,NEW \\
        --order 0,1,1,0 --out build/path_ab.json

``OLD`` and ``NEW`` are checkouts of the repository (a parent unpacked
with ``git archive`` into a directory ``.gitignore`` lists, and ``.``).
Each entry of ``--order`` starts one process in that tree (its own
``src/`` and ``chip_smoke.py`` first on the path, its kernels built into
its own ``build/``), which measures, with the tree's own code:

* K1, K2 and K3 per Python call through ``kernels.ops`` and through the
  binding alone (the wrapper's and dispatcher's share), and a threefry
  normal draw (``prng.normal``) at the FCN's and Qwen2-0.5B's shapes;
* the FCN step per backend (``chip_smoke.phase_fcn``), LeNet-5's harness
  step (``chip_smoke.host_sync_cost``) and the Tables runs of E-RIDER on
  the FCN and LeNet-5 (``chip_smoke.paper_run``), ms a step;
* phase 10a's Qwen2-0.5B step (``chip_smoke.phase_lm``) and 11b-c's
  MiniCPM3-4B / Mamba2-2.7B at 8 layers (``chip_smoke.lm_full_width``):
  ms a step and the peak allocated GiB;
* serving: the serve CLI on Qwen2-0.5B from ``LM.init`` (16 requests,
  prompt 128, 32 tokens, 8 lanes), TPOT p50 and the decode step;
* zero-shifting (``core.zs.zs_estimate``, fig1's 64 x 64 device), ms a
  pulse;
* the kernels alone, device time by CUDA graph replay
  (``chip_smoke.time_ms``): K1 in both noise modes, out of place and in
  place, at phase 3's four shapes, ``hash_normal`` and ``hash_device``
  (the CLI's P and W devices and one without sigma_d2d) at (896, 4864) and
  (24, 896, 4864).

``--only`` picks some of them. Only functions both trees have are
called. The parent prints one table, a column a run, and writes every
number to ``--out``. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _per_call_ms(fn, reps: int = 200) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` calls, synchronized
    before and after (the launch cost included), median of 5."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(out)


def _calls(cs) -> dict:
    """Per-call times of the kernels, their bindings and normal draws."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.analog_matmul import analog_mvm_cuda
    from repro_torch.kernels.analog_update import analog_update_cuda
    from repro_torch.kernels.sp_filter import sp_filter_cuda

    r = {}
    kw = dict(dw_min=1e-3, tau_min=0.9, tau_max=1.1, sigma_c2c=0.05)
    for shape in ((784, 256), (896, 4864)):
        tag = "x".join(map(str, shape))
        w, dw, g, rho = cs.update_operands(shape, torch.float32, 3, "cuda")
        ub, z = ops.make_noise(prng.PRNGKey(4), shape, "cuda")
        ub32 = ub.to(torch.int32)
        r[f"k1_ops_{tag}"] = _per_call_ms(lambda: ops.analog_update(
            w, dw, g, rho, None, noise=(ub, z), **kw))
        r[f"k1_binding_{tag}"] = _per_call_ms(lambda: analog_update_cuda(
            w, dw, g, rho, ub32, z, **kw))
        q, p, g2, rho2 = cs.sp_operands(shape, (w.dtype, w.dtype), 5, "cuda")
        sk = dict(eta=0.3, tau_min=0.7, tau_max=1.3)
        r[f"k2_ops_{tag}"] = _per_call_ms(lambda: ops.sp_filter(
            q, p, g2, rho2, **sk))
        r[f"k2_binding_{tag}"] = _per_call_ms(lambda: sp_filter_cuda(
            q, p, g2, rho2, **sk))
        key = prng.PRNGKey(6)
        r[f"normal_{tag}"] = _per_call_ms(lambda: prng.normal(key, shape,
                                                              "cuda"), 50)
    for (xs, ws), tag in ((((64, 784), (784, 256)), "fcn"),
                          (((2048, 896), (896, 4864)), "lm")):
        x, w = cs.mvm_operands(xs, ws, torch.float32, 7, "cuda")
        noise = prng.normal(prng.PRNGKey(8), (xs[0], ws[1]), "cuda")
        r[f"k3_ops_{tag}"] = _per_call_ms(lambda: ops.analog_mvm(
            x, w, None, noise=noise, **cs.MVM_IO), 50)
        r[f"k3_binding_{tag}"] = _per_call_ms(lambda: analog_mvm_cuda(
            x, w, noise, **cs.MVM_IO), 50)
    return r


def _serve_tpot() -> dict:
    import contextlib
    import io

    from repro_torch.launch import serve

    argv = ["--arch", "qwen2-0.5b", "--requests", "16", "--prompt-len",
            "128", "--gen", "32", "--data-vocab", "8192", "--device", "cuda"]
    out = {}
    for run in range(2):          # the first warms the allocator and caches
        with contextlib.redirect_stdout(io.StringIO()):
            _, summary, engine = serve.main(argv)
        lat = engine.telemetry.latency_summary()
        out = dict(tpot_p50_ms=lat["tpot"]["p50"] * 1e3,
                   decode_step_ms=lat["gap"]["p50"] * 1e3,
                   tokens_per_s=summary["tokens_per_s"])
        del engine
    return out


def _zs_ms_per_pulse(pulses: int = 300) -> float:
    import torch

    from repro_torch import prng
    from repro_torch.core import zs
    from repro_torch.core.device import (DeviceConfig, sample_device)

    key = prng.PRNGKey(0)
    cfg = DeviceConfig(dw_min=0.001, sigma_pm=0.3, sigma_d2d=0.1,
                       sigma_c2c=0.05)
    dp = sample_device(key, (64, 64), cfg, device="cuda")
    w = torch.zeros((64, 64), device="cuda")
    zs.zs_estimate(prng.fold_in(key, 1), w, dp, cfg, 20, tail_average=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs.zs_estimate(prng.fold_in(key, 2), w, dp, cfg, pulses,
                   tail_average=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / pulses


# phase 3's K1 shapes: the FCN's fc1, Qwen2-0.5B's MLP tile (f32), its
# stacked mlp/wi of 24 layers and Mixtral's 4-D expert stack (bf16 w)
K1_SHAPES = (((784, 256), "float32", 20, 15), ((896, 4864), "float32", 20, 15),
             ((24, 896, 4864), "bfloat16", 3, 5),
             ((1, 8, 4096, 14336), "bfloat16", 3, 5))
K1_KW = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=10)


def _k1_times(cs, shape, dtype, reps, rounds, modes=("operand", "hash")):
    """K1's device ms through its bindings: {mode: (out of place, in
    place)} on the same operands (f32 dw; a seed a member for the hash
    mode, as phase 3 times it)."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import fastrng
    from repro_torch.kernels.analog_update import (analog_update_cuda,
                                                   analog_update_hash_cuda)

    w, dw, g, rho = cs.update_operands(shape, getattr(torch, dtype), 9,
                                       "cuda", torch.float32)
    hash_shape = shape
    out = {}
    if "operand" in modes:
        # the binding takes 2-D or 3-D: a 4-D stack as ops._view2d sees it
        w, dw, g, rho = (t.view(-1, shape[-1]) if len(shape) > 3 else t
                         for t in (w, dw, g, rho))
        shape = w.shape
        ku, kz = prng.split(prng.PRNGKey(9))
        ub = prng.bits(ku, shape, "cuda").to(torch.int32)
        z = prng.normal(kz, shape, "cuda")
        out["operand"] = (
            cs.time_ms(lambda: analog_update_cuda(w, dw, g, rho, ub, z,
                                                  **K1_KW), reps, rounds)[0],
            cs.time_ms(lambda: analog_update_cuda(w, dw, g, rho, ub, z,
                                                  out=w, **K1_KW),
                       reps, rounds)[0])
        del ub, z
    if "hash" in modes:
        key, _ = cs.hash_keys(hash_shape, 9)
        seeds = fastrng.device_seeds(fastrng.seed_from_key(key),
                                     "cpu").reshape(-1, 2).to("cuda")
        out["hash"] = (
            cs.time_ms(lambda: analog_update_hash_cuda(w, dw, g, rho, seeds,
                                                       **K1_KW),
                       reps, rounds)[0],
            cs.time_ms(lambda: analog_update_hash_cuda(w, dw, g, rho, seeds,
                                                       out=w, **K1_KW),
                       reps, rounds)[0])
    del w, dw, g, rho
    torch.cuda.empty_cache()
    return out


def _kernels(cs) -> dict:
    """Device ms of K1 (both modes, out of place and in place, phase 3's
    shapes), hash_normal and hash_device (three configs) at (896, 4864)
    and (24, 896, 4864), one seed."""
    import torch

    from repro_torch.core.device import DeviceConfig
    from repro_torch.kernels import fastrng
    from repro_torch.kernels.ref import device_scalars

    r = {}
    for shape, dtype, reps, rounds in K1_SHAPES:
        tag = "x".join(map(str, shape))
        for mode, (oop, ip) in _k1_times(cs, shape, dtype, reps,
                                         rounds).items():
            r[f"k1_{mode}_{tag}"] = oop
            r[f"k1_{mode}_inplace_{tag}"] = ip
    for shape, reps, rounds in (((896, 4864), 20, 15),
                                ((24, 896, 4864), 3, 5)):
        tag = "x".join(map(str, shape))
        key, _ = cs.hash_keys(shape[-2:], 60)
        seeds = fastrng.device_seeds(fastrng.seed_from_key(key),
                                     "cpu").reshape(-1, 2).to("cuda")
        out = torch.empty(shape, device="cuda")
        r[f"hash_normal_{tag}"] = cs.time_ms(
            lambda: fastrng.hash_normal_cuda(seeds, out, 11), reps,
            rounds)[0]
        rho = torch.empty_like(out)
        for name, fields in cs.HASH_DEVICES.items():
            sc = device_scalars(DeviceConfig(**fields))
            r[f"hash_device_{name}_{tag}"] = cs.time_ms(
                lambda: fastrng.hash_device_cuda(seeds, out, rho, **sc),
                reps, rounds)[0]
        del out, rho
        torch.cuda.empty_cache()
    return r


MEASURES = ("calls", "fcn", "paper", "zs_ms_per_pulse", "lm_10a", "lm_11",
            "serve", "kernels")


def worker(tree: str, only=MEASURES) -> dict:
    """The measurements named in ``only``, with ``tree``'s code; a failed
    one is recorded as its error."""
    import contextlib
    import io

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"tree": tree, "card": cs.smi_line()}
    t0 = time.time()
    cuda_build.build()
    res["build_s"] = time.time() - t0

    def fcn():
        return {b: cs.phase_fcn("cuda", b)[1] for b in ("vmap", "fused")}

    def paper():
        from repro_torch.benchmarks.common import cuda_numerics, device_pair
        from repro_torch.data import ImageDataset

        cuda_numerics()
        out = {f"lenet5_{k}": v for k, v in cs.host_sync_cost(
            res["card"]).items()}
        dev_p, dev_w = device_pair(**cs.TABLES_DEVICE)
        data = ImageDataset(n_train=4096, n_test=1024, seed=11)
        for kind in ("fcn", "lenet5"):
            r, _ = cs.paper_run(kind, algorithm="erider", model_kind=kind,
                                dev_p=dev_p, dev_w=dev_w, epochs=2,
                                data=data, seed=1)
            out[f"tables_{kind}_erider_ms"] = r.wall_s * 1e3 / len(r.losses)
        return out

    def lm_numbers(r, steps):
        # the hash kernels' launches a step, where the tree counts them
        out = dict(step_ms=r["step_ms"], peak_gib=r["peak_bytes"] / 2 ** 30)
        for k in ("normal_launches", "device_launches"):
            if k in r:
                out[f"{k}_per_step"] = r[k] / steps
        return out

    def lm():
        return lm_numbers(cs.phase_lm("cuda", res["card"]), cs.LM_STEPS)

    def full():
        return {a: lm_numbers(cs.lm_full_width(a, s, res["card"]),
                              cs.FULL_STEPS) for a, s in cs.FULL_WIDTH}

    fns = dict(calls=lambda: _calls(cs), fcn=fcn, paper=paper,
               zs_ms_per_pulse=_zs_ms_per_pulse, lm_10a=lm, lm_11=full,
               serve=_serve_tpot, kernels=lambda: _kernels(cs))
    for name in only:
        fn = fns[name]
        t1 = time.time()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                res[name] = fn()
        except (Exception, SystemExit) as e:  # recorded; the next one runs
            res[name] = f"error: {type(e).__name__}: {e}"
        res[f"{name}_s"] = time.time() - t1
        torch.cuda.empty_cache()
        print(f"path_ab: {tree}: {name} {res[name]}", file=sys.stderr,
              flush=True)
    return res


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", required=True,
                    help="comma-separated checkouts, e.g. build/parent,.")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--out", default="build/path_ab.json")
    ap.add_argument("--only", default=",".join(MEASURES),
                    help=f"comma-separated subset of {','.join(MEASURES)}")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        # the tree's code first: not this script's directory (sys.path[0])
        tree = args.worker
        sys.path[:1] = [tree, os.path.join(tree, "src")]
        print(json.dumps(worker(tree, args.only.split(","))))
        return 0
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    runs = []
    for i in (int(x) for x in args.order.split(",")):
        tree = trees[i]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [tree, os.path.join(tree, "src")]))
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "path_ab.py"), "--trees",
             tree, "--worker", tree, "--only", args.only], cwd=tree, env=env,
            stdout=subprocess.PIPE, text=True, timeout=1500)
        if p.returncode != 0:
            print(f"path_ab: {tree} exited {p.returncode}", file=sys.stderr)
            return p.returncode
        runs.append(dict(index=i, **json.loads(p.stdout.strip().splitlines()[-1])))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    keys = [k for k, v in _flat(runs[0]) if isinstance(v, (int, float))]
    print("metric," + ",".join(f"run{j}:tree{r['index']}"
                               for j, r in enumerate(runs)))
    for k in keys:
        vals = [dict(_flat(r)).get(k) for r in runs]
        print(k + "," + ",".join(f"{v:.4f}" if isinstance(v, (int, float))
                                 else str(v) for v in vals))
    print(runs[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
