"""Multi-rank programs of the port's distribution tests, and their launcher.

``run(program, world, workdir, ...)`` starts ``world`` processes of this
module, one per rank (a gloo process group over a rendezvous file in
``workdir``), waits for all of them within ``timeout`` seconds (a hung
collective kills every rank and fails the test) and returns each rank's
result; ``start`` returns at once and ``Ranks.wait`` collects them. A
program is a function ``(mesh_or_None, device, **kw) -> dict`` of this
module's ``PROGRAMS``; each rank's result is ``torch.save``'d.
It imports no JAX: the card tests run these programs too.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def run(program: str, world: int, workdir: str, timeout: float = 120,
        device: str = "cpu", **kw):
    """Run ``program`` on ``world`` ranks; returns [rank 0's result, ...]."""
    return start(program, world, workdir, timeout, device, **kw).wait()


class Ranks:
    """Ranks started by ``start``; ``wait()`` returns their results."""

    def __init__(self, program, procs, timeout):
        self.program, self.procs = program, procs
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self):
        try:
            for _, p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for _, p in self.procs:
                p.kill()
            raise AssertionError(f"{self.program} on {len(self.procs)} ranks "
                                 f"did not finish in {self.timeout} s")
        bad = [r for r, (_, p) in enumerate(self.procs) if p.returncode != 0]
        if bad:
            with open(self.procs[bad[0]][0] + ".log") as f:
                log = f.read()
            raise AssertionError(f"{self.program}: ranks {bad} failed; rank "
                                 f"{bad[0]}:\n" + log[-3000:])
        return [torch.load(out, weights_only=False) for out, _ in self.procs]


def start(program: str, world: int, workdir: str, timeout: float = 120,
          device: str = "cpu", **kw) -> Ranks:
    """Start ``program`` on ``world`` ranks and return at once, so the
    caller can work while they run (``Ranks.wait``); each rank's output
    goes to a log file beside its result."""
    os.makedirs(workdir, exist_ok=True)
    tag = time.time_ns()
    init_file = os.path.join(workdir, f"rdzv_{program}_{tag}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        out = os.path.join(workdir, f"{program}_{tag}_rank{r}.pt")
        with open(out + ".log", "w") as log:
            procs.append((out, subprocess.Popen(
                [sys.executable, "-m", "torch_ranks", program, str(r),
                 str(world), init_file, out, device, json.dumps(kw)],
                env=env, cwd=HERE, stdout=log, stderr=subprocess.STDOUT)))
    return Ranks(program, procs, timeout)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def compress(mesh, device, x_file, err_file):
    """``compressed_psum_mean`` and ``make_compressed_grad_fn`` on this
    rank's row of the seeded inputs."""
    from repro_torch.distributed import compression, runtime

    r = runtime.rank()
    x = torch.load(x_file)[r].to(device)
    err = torch.load(err_file)[r].to(device)
    mean, new_err = compression.compressed_psum_mean(x, torch.distributed.group.WORLD)
    fn = compression.make_compressed_grad_fn(mesh, "data")
    mean2, err2 = fn(x, err)
    return {"mean": mean.cpu(), "err": new_err.cpu(), "fb_mean": mean2.cpu(),
            "fb_err": err2.cpu(), "route": runtime.route(x),
            "backend": runtime.backend()}


def _bank_trainer(mesh, backend="vmap", engine="grouped", kind="ref"):
    """The reference's 2x2 trainer (SGD, constant 0.1); the mixed bank's
    digital leaves take Adam with clipping."""
    from repro_torch.core.device import DeviceConfig
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.tile import TileConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig

    dev = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    cfg = TrainerConfig(
        tile=TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                        update_backend=backend,
                        rng="hash" if backend == "fused" else "threefry"),
        digital=(DigitalOptConfig(kind="sgd") if kind == "ref" else
                 DigitalOptConfig(kind="adam", clip_norm=1.0)),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1),
        engine=engine)
    return AnalogTrainer(bank_loss, cfg, analog_filter=bank_filter, mesh=mesh)


def bank_filter(path, leaf):
    return getattr(leaf, "ndim", 0) >= 2 and "embed" not in path


def bank_loss(params, batch, rng):
    """sum(v^2) of every leaf, scaled by the batch's mean when there is a
    batch. The mixed bank's rows of x have the same mean on every rank, so
    the data-axis average is exact and the run bit-equal to one process."""
    from repro_torch.core.paths import flatten_with_path

    total = sum(torch.sum(v.to(torch.float32) ** 2)
                for _, v in sorted(flatten_with_path(params)))
    if isinstance(batch, dict):
        total = total * torch.mean(batch["x"])
    return total, {}


def bank_params(kind: str, device="cpu"):
    """The reference's 2x2 case (``tests/test_distributed.py``), or a mixed
    bank: rows with the model axis on a member dim, a stack that does not
    divide (the gather-all fallback), a class that divides only flattened
    ('fused'), and digital leaves with Adam moments."""
    if kind == "ref":
        p = {}
        for i in range(2):
            p[f"l{i}/attn/wq"] = 0.1 * torch.ones((8, 8))
            p[f"l{i}/attn/wo"] = 0.1 * torch.ones((8, 8))
        return {k: v.to(device) for k, v in p.items()}
    g = torch.Generator().manual_seed(5)

    def w(*shape):
        return (0.1 * torch.randn(shape, generator=g)).to(device)

    p = {f"l{i}/mlp/wi": w(8, 16) for i in range(2)}
    p.update({f"l{i}/attn/wq": w(8, 12) for i in range(3)})
    p.update({"x/attn/wq": w(4, 8), "x/attn/wo": w(4, 8)})
    p.update({"embed": w(16, 8), "l0/mlp/bq": w(8)})
    return p


def bank_batch(kind: str, device="cpu"):
    if kind == "ref":
        return torch.zeros(())
    return {"x": torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)}


def bank(mesh, device, kind="ref", backend="vmap", engine="grouped", steps=2,
         state_file="", donate=False):
    """Init under the mesh (specs, bytes per rank), then ``steps`` steps
    from the whole state in ``state_file`` (or from that init), gathered;
    rank 0 also runs the one-process steps from the same state.
    ``donate``: the ranks run the donated step, and ``kept`` tells whether
    every block kept its storage (``moved`` lists those that did not)."""
    from repro_torch import prng
    from repro_torch.core.paths import flatten_with_path, leaves, tree_map
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import gather_tree, local_shape
    from repro_torch.kernels import ops

    tr = _bank_trainer(mesh, backend, engine, kind)
    params = bank_params(kind, device)
    state = tr.init(prng.PRNGKey(0), params)
    specs = {p: tuple(s.spec) for p, s in flatten_with_path(tr.shardings)}
    whole0 = gather_tree(state, tr.shardings)
    total = sum(t.numel() * t.element_size() for t in leaves(whole0["tiles"]))
    per_rank = sum(t.numel() * t.element_size() for t in leaves(state["tiles"]))
    shapes_ok = all(
        tuple(t.shape) == local_shape(w.shape, specs[p], mesh)
        for (p, t), (_, w) in zip(flatten_with_path(state),
                                  flatten_with_path(whole0)))
    if state_file:
        whole0 = _to(torch.load(state_file, weights_only=False), device)
        state = tr.shard_state(whole0)
    if donate:
        # the gather hands back a replicated block itself, which the
        # donated steps write: the one-process run starts from a copy
        whole0 = tree_map(torch.clone, whole0)
    batch = bank_batch(kind, device)
    ops.reset_launch_counts()
    metrics = []
    step = tr.jit_step(donate)
    ptrs = {p: t.untyped_storage().data_ptr()
            for p, t in flatten_with_path(state)}
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: v.cpu() for k, v in m.items()})
    moved = [p for p, t in flatten_with_path(state)
             if t.untyped_storage().data_ptr() != ptrs[p]]
    launches = ops.LAUNCHES["analog_update"]
    bank_ = state["tiles"]
    out = {"names": [g for g, _ in getattr(bank_, "index", ())],
           "classes": [c for c, _ in getattr(bank_, "class_index", ())],
           "specs": specs, "total": total, "per_rank": per_rank,
           "shapes_ok": shapes_ok, "metrics": metrics, "launches": launches,
           "kept": not moved, "moved": moved,
           "state": _to(tr.gather_state(state), "cpu")}
    if runtime.rank() == 0:
        one = _bank_trainer(None, backend, engine, kind)
        s1 = whole0
        m1 = []
        for _ in range(steps):
            s1, m = one.train_step(s1, batch)
            m1.append({k: v.cpu() for k, v in m.items()})
        out.update(one_state=_to(s1, "cpu"), one_metrics=m1)
    return out


def elastic(mesh, device, directory, state_file):
    """Save from this mesh, restore onto the other factorizations of the
    world and gather; x is the reference's (64, 32) arange."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  gather_tree, shard_tree)
    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.distributed.sharding import (constrain_stacked,
                                                  shard_stacked_call)

    world = mesh.size
    stack = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    out = {"coords": mesh.coords(),
           "constrained": constrain_stacked(
               {"W": stack, "t": torch.arange(4)}, ("attn/wq",), mesh),
           "rows": shard_stacked_call(lambda a: 2 * a, mesh, 4, stack),
           "odd": shard_stacked_call(lambda a: 2 * a, mesh, 3, stack[:3])}
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32).to(device)
    sh1 = {"x": NamedSharding(mesh, P("data", "model"))}
    ckpt.save(shard_tree({"x": x}, sh1), os.path.join(directory, "x"), step=1,
              shardings=sh1)
    # a trainer state saved from this mesh
    tr = _bank_trainer(mesh)
    local = tr.shard_state(_to(torch.load(state_file, weights_only=False),
                               device))
    ckpt.save(local, os.path.join(directory, "state"), step=1,
              shardings=tr.shardings)
    for data, model in ((world, 1), (1, world)):
        mesh2 = make_host_mesh(data, model)
        sh2 = {"x": NamedSharding(mesh2, P("data", "model"))}
        back = ckpt.restore({"x": x}, os.path.join(directory, "x"),
                            shardings=sh2)
        tr2 = _bank_trainer(mesh2)
        template = tr2.abstract_state(bank_params("ref", "meta"), device)
        st = ckpt.restore(template, os.path.join(directory, "state"),
                          shardings=tr2.shardings)
        out[(data, model)] = {
            "x_local": tuple(back["x"].shape),
            "x": gather_tree(back, sh2)["x"].cpu(),
            "state": _to(tr2.gather_state(st), "cpu")}
    return out


def cli(mesh, device, argv):
    """``repro_torch.launch.train.main`` on this rank; returns the history
    and the gathered final state."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.configs import get_config

    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_host_mesh

    def flag(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    runtime.reset_stats()
    state, hist = train.main(argv)
    stats = {k: dict(v) for k, v in runtime.STATS.items()}
    mesh = make_host_mesh(int(flag("--data-parallel", 1)),
                          int(flag("--model-parallel", 1)))
    model = LM(get_config(flag("--arch", "qwen2-0.5b"), smoke=True))
    tr = train.make_trainer(model, "erider", True, 1, mesh=mesh)
    tr.abstract_state(model.abstract_params(device), device)
    return {"history": hist, "stats": stats,
            "state": _to(gather_tree(state, tr.shardings), "cpu")}


def lm_micro(mesh, device, arch, batch, seq, microbatch, steps):
    """``steps`` train steps of the CLI's trainer on the smoke ``arch``
    with ``microbatch`` slices of each global batch; returns the metrics
    and the gathered final state (one process when ``mesh`` is None)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import BigramLM
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg = get_config(arch, smoke=True)
    model = LM(cfg)
    tr = train.make_trainer(model, "erider", True, steps, mesh=mesh)
    tr.cfg = dataclasses.replace(tr.cfg, microbatch=microbatch)
    state = tr.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), device))
    data = BigramLM(vocab=cfg.vocab, seed=7)
    hist = []
    for s in range(steps):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch(s, batch, seq).items()}
        state, m = tr.train_step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    if tr.mesh is not None:
        state = tr.gather_state(state)
    return {"history": hist, "state": _to(state, "cpu")}


def cli_runs(mesh, device, argvs):
    """``cli`` for each of ``argvs`` in turn on these ranks."""
    return [cli(mesh, device, argv) for argv in argvs]


def lm_batches(cfg, batch: int, seq: int, steps: int, device="cpu"):
    """The CLI's bigram batches (seed 7), with seeded ``frames`` for a
    model with a frontend."""
    import numpy as np

    from repro_torch.data.synthetic import BigramLM

    data = BigramLM(vocab=cfg.vocab, seed=7)
    rng = np.random.default_rng(18)
    out = []
    for s in range(steps):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch(s, batch, seq).items()}
        if cfg.frontend:
            b["frames"] = torch.from_numpy((0.1 * rng.standard_normal(
                (batch, seq, cfg.d_model))).astype(np.float32)).to(device)
        out.append(b)
    return out


def lm_steps(mesh, device, arch, batch, seq, steps, change=None):
    """``steps`` train steps of the CLI's trainer on the smoke ``arch``
    (``lm_batches``), its config changed by ``change`` when given; returns
    the metrics, the gathered final state and the collectives counted (one
    process when ``mesh`` is None)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.distributed import runtime
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(arch, smoke=True), **(change or {}))
    model = LM(cfg)
    tr = train.make_trainer(model, "erider", True, steps, mesh=mesh)
    state = tr.init(prng.PRNGKey(1), model.init(prng.PRNGKey(0), device))
    runtime.reset_stats()
    hist = []
    for b in lm_batches(cfg, batch, seq, steps, device):
        state, m = tr.train_step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    stats = {k: dict(v) for k, v in runtime.STATS.items()}
    if tr.mesh is not None:
        state = tr.gather_state(state)
    return {"history": hist, "state": _to(state, "cpu"), "stats": stats}


# ---------------------------------------------------------------------------
# tensor parallel: the operators and the split modules on a model axis
# ---------------------------------------------------------------------------


def _seeded(seed, shape, scale=1.0):
    import numpy as np

    return torch.from_numpy(np.asarray(scale * np.random.default_rng(seed)
                                       .standard_normal(tuple(shape)),
                                       dtype=np.float32))


def _tp_run(fn, params, args, dims, axis, seed):
    """``fn(params, *args)`` and the gradients of ``sum(out * R) [+ the
    other outputs]`` (R seeded) w.r.t. every float argument and parameter:
    one process on whole ``params`` and under ``model_parallel(*axis)`` on
    this rank's blocks (``dims``: {name: split dim from the end}). Returns
    both, the reference's parameter gradients cut to this rank's blocks,
    and the collectives the split forward counted."""
    import contextlib

    from repro_torch.distributed import runtime
    from repro_torch.models.common import model_parallel

    group, size, index = axis

    def cut(name, t):
        d = dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // size
        return t.narrow(d, index * n, n)

    def once(split):
        ps = {k: (cut(k, v) if split else v).detach().clone()
              .requires_grad_(True) for k, v in params.items()}
        xs = [a.detach().clone().requires_grad_(a.is_floating_point())
              for a in args]
        ctx = model_parallel(group, size, index) if split else \
            contextlib.nullcontext()
        with ctx:
            runtime.reset_stats()
            out = fn(ps, *xs)
            calls = {k: v["calls"] for k, v in runtime.STATS.items()}
            outs = out if isinstance(out, tuple) else (out,)
            r = _seeded(seed, outs[0].shape)
            loss = torch.sum(outs[0] * r) + sum(torch.sum(o) for o in outs[1:])
            wrt = [x for x in xs if x.requires_grad] + list(ps.values())
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        gx = grads[:len(wrt) - len(ps)]
        gp = dict(zip(ps, grads[len(wrt) - len(ps):]))
        return [o.detach() for o in outs], list(gx), gp, calls

    out, gx, gp, calls = once(True)
    calls_all = {k: v["calls"] for k, v in runtime.STATS.items()}
    rout, rgx, rgp, _ = once(False)
    rgp = {k: (None if g is None else cut(k, g)) for k, g in rgp.items()}
    return {"out": out, "ref_out": rout, "dx": gx, "ref_dx": rgx,
            "grads": gp, "ref_grads": rgp, "calls": calls,
            "calls_all": calls_all}


def _layer_params(flat, layout, prefix):
    """The parameters of one layer, period 0 of the body stack at
    ``prefix`` of the whole ``flat`` tree, and the dim ``layout`` splits
    each on (None: whole)."""
    params = {p[len(prefix) + 1:]: t[0] for p, t in flat.items()
              if p.startswith(prefix + "/")}
    return params, {k: layout.dim(f"{prefix}/{k}") for k in params}


def _tp_module_cases():
    """{case: (arch, config changes, module prefix, layer kind, tokens)}"""
    return {
        "gqa_bias": ("qwen2-0.5b", {}, "stack/body/p0/attn", "attn", 32),
        "qk_norm": ("qwen3-14b", {}, "stack/body/p0/attn", "attn", 32),
        "window_kv_whole": ("gemma3-4b", {}, "stack/body/p0/attn",
                            "attn_local", 40),
        "mrope": ("qwen2-vl-2b", {}, "stack/body/p0/attn", "attn", 32),
        "mlp": ("qwen2-0.5b", {}, "stack/body/p0/mlp", "mlp", 32),
        "moe_einsum": ("mixtral-8x7b", {}, "stack/body/p0/moe", "moe", 320),
        "moe_gather": ("mixtral-8x7b", {}, "stack/body/p0/moe", "moe", 64),
        "moe_ragged": ("mixtral-8x7b", {"moe_impl": "ragged"},
                       "stack/body/p0/moe", "moe", 320),
        "moe_shared": ("deepseek-v2-236b", {}, "stack/body/p0/moe", "moe",
                       320),
        "vocab": ("qwen2-0.5b", {}, "", "vocab", 32),
    }


def tp_modules(mesh, device, cases=None):
    """Each case of ``_tp_module_cases`` on this rank's blocks (cut by the
    CLI's ``tp_layout``) against one process, plus the operators alone:
    a column-then-row product between ``copy_to_model`` and
    ``reduce_from_model``, ``vocab_rows`` and the vocab-parallel CE (z-loss,
    a mask, argmax ties inside and across the blocks)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.distributed import sharding
    from repro_torch.models import attention, common, moe
    from repro_torch.models.lm import LM

    axis = (mesh.group("model"), mesh.shape["model"], mesh.index("model"))
    out = {}
    for name, (arch, change, prefix, kind, n_tok) in _tp_module_cases().items():
        if cases is not None and name not in cases:
            continue
        cfg = dataclasses.replace(get_config(arch, smoke=True), **change)
        model = LM(cfg)
        whole = model.init(prng.PRNGKey(3), device)
        layout = sharding.tp_layout(cfg, mesh)
        flat = dict(flatten_with_path(whole))
        B, S = 2, n_tok // 2
        x = _seeded(11, (B, S, cfg.d_model))
        if kind == "vocab":
            params = {"embed": flat["embed"], "ln_f": flat["ln_f"]}
            dims = {"embed": layout.dim("embed")}
            ids = torch.arange(B * S).reshape(B, S) * 37 % cfg.vocab

            def fn(p, ids, labels):
                h = model._embed(p, ids)
                logits = model._logits(p, h)
                return common.softmax_cross_entropy(logits, labels,
                                                    vocab=cfg.vocab)[0]

            args = (ids, (ids * 5 + 1) % cfg.vocab)
        else:
            params, dims = _layer_params(flat, layout, prefix)
            args = (x,)
            if kind in ("attn", "attn_local"):
                # (B, S), as ``LM.forward`` passes them (M-RoPE takes three
                # equal streams of text positions)
                pos = torch.arange(S)[None].expand(B, S)

                def fn(p, x, kind=kind, pos=pos):
                    return attention.attn_forward(p, x, cfg, kind=kind,
                                                  positions=pos)
            elif kind == "mlp":
                def fn(p, x):
                    return moe.mlp_forward(p, x, cfg)
            else:
                def fn(p, x):
                    return moe.moe_forward(p, x, cfg)
        res = _tp_run(fn, params, args, dims, axis, seed=12)
        res["split"] = sorted(k for k, d in dims.items() if d is not None)
        out[name] = res
    if cases is None or "ops" in cases:
        out["ops"] = _tp_ops(axis)
    return out


def _tp_ops(axis):
    """The operators alone (see ``tp_modules``)."""
    from repro_torch.models import common

    w, v = _seeded(21, (6, 8)), _seeded(22, (8, 5))

    def mlp(p, x):
        h = torch.tanh(common.copy_to_model(x) @ p["w"])
        return common.reduce_from_model(h @ p["v"])

    table = _seeded(23, (16, 4))
    ids = torch.tensor([[0, 7, 8, 15, 3], [9, 9, 1, 14, 8]])

    def read(p, ids):
        return common.vocab_rows(p["table"], ids, 16)

    logits = _seeded(24, (2, 3, 16))
    # ties for the argmax: inside block 0 (ids 2, 5), across the blocks
    # (ids 6 and 9), and one whole row of equal logits
    logits[0, 0, 2] = logits[0, 0, 5] = 9.0
    logits[0, 1, 6] = logits[0, 1, 9] = 9.0
    logits[1, 2, :] = 0.5
    labels = torch.tensor([[2, 9, 4], [0, 15, 0]])
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])

    def ce(p, labels, mask):
        loss, aux = common.softmax_cross_entropy(p["logits"], labels, mask,
                                                 z_loss=1e-2, vocab=16)
        return torch.stack([loss, aux["ce"], aux["accuracy"]])

    return {"mlp": _tp_run(mlp, {"w": w, "v": v}, (_seeded(25, (3, 6)),),
                           {"w": -1, "v": -2}, axis, seed=26),
            "rows": _tp_run(read, {"table": table}, (ids,), {"table": -2},
                            axis, seed=27),
            "ce": _tp_run(ce, {"logits": logits}, (labels, mask),
                          {"logits": -1}, axis, seed=28)}


def _tp_mixer_cases():
    """{case: (arch, config changes, module prefix, layer kind, batch,
    seq)}: the mixers of item 15c, one layer each. Mamba2's smoke chunk is
    16 tokens, so 20 pad a tail of 12."""
    mla, mix = "stack/body/p0/attn", "stack/body/p0/mix"
    cross = "stack/body/p0/cross"
    return {
        "mla_expanded": ("minicpm3-4b", {}, mla, "mla", 2, 16),
        "mla_absorbed": ("minicpm3-4b", {"mla_absorbed": True}, mla, "mla",
                         2, 16),
        "rglru": ("recurrentgemma-9b", {}, mix, "rec", 2, 16),
        "ssd_g1": ("mamba2-2.7b", {}, mix, "ssm", 2, 20),
        "ssd_g2": ("mamba2-2.7b", {"ssm_groups": 2}, mix, "ssm", 2, 20),
        "cross_kv_split": ("seamless-m4t-large-v2", {}, cross, "cross", 2,
                           16),
        "cross_kv_whole": ("seamless-m4t-large-v2", {"n_kv": 1}, cross,
                           "cross", 2, 16),
    }


def tp_mixers(mesh, device):
    """Each case of ``_tp_mixer_cases`` on this rank's blocks (cut by
    ``tp_layout``) against one process; the gated norm alone (over split
    channels, then a row-split product); the encoder-decoder's whole loss
    with frames (``LM.loss``)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path, tree_map_with_path
    from repro_torch.distributed import sharding
    from repro_torch.models import attention, common, recurrent
    from repro_torch.models.lm import LM

    axis = (mesh.group("model"), mesh.shape["model"], mesh.index("model"))
    out = {}
    for name, (arch, change, prefix, kind, B, S) in _tp_mixer_cases().items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **change)
        whole = dict(flatten_with_path(LM(cfg).init(prng.PRNGKey(3), device)))
        params, dims = _layer_params(whole, sharding.tp_layout(cfg, mesh),
                                     prefix)
        pos = torch.arange(S)[None].expand(B, S)
        args = (_seeded(11, (B, S, cfg.d_model)),)
        if kind == "mla":
            def fn(p, x, cfg=cfg, pos=pos):
                return attention.mla_forward(p, x, cfg, positions=pos)
        elif kind == "rec":
            def fn(p, x, cfg=cfg):
                return recurrent.rglru_forward(p, x, cfg)
        elif kind == "ssm":
            def fn(p, x, cfg=cfg):
                return recurrent.ssm_forward(p, x, cfg)
        else:
            args += (_seeded(13, (B, S + 4, cfg.d_model)),)

            def fn(p, x, enc, cfg=cfg):
                return attention.cross_forward(p, x, enc, cfg)
        res = _tp_run(fn, params, args, dims, axis, seed=12)
        res["split"] = sorted(k for k, d in dims.items() if d is not None)
        out[name] = res

    def gated_norm(p):
        y = common.rms_norm_over_model(p["y"] * F.silu(p["z"]), p["w"])
        return common.reduce_from_model(y @ p["v"])

    out["gated_norm"] = _tp_run(
        gated_norm, {"y": _seeded(31, (2, 5, 12)), "z": _seeded(32, (2, 5, 12)),
                     "w": _seeded(33, (12,), 0.1), "v": _seeded(34, (12, 5))},
        (), {"y": -1, "z": -1, "v": -2}, axis, seed=35)

    cfg = get_config("seamless-m4t-large-v2", smoke=True)
    model = LM(cfg)
    tree = model.init(prng.PRNGKey(3), device)
    layout = sharding.tp_layout(cfg, mesh)
    flat = dict(flatten_with_path(tree))
    batch = lm_batches(cfg, 4, 16, 1, device)[0]

    def encdec(p, frames):
        params = tree_map_with_path(lambda q, _: p[q], tree)
        return model.loss(params, {"tokens": batch["tokens"],
                                   "labels": batch["labels"],
                                   "frames": frames}, None)[0]

    res = _tp_run(encdec, flat, (batch["frames"],),
                  {p: layout.dim(p) for p in flat}, axis, seed=36)
    res["all_reduces"] = layout.all_reduces()
    out["encdec"] = res
    return out


def tp_mixers_all(mesh, device, argvs, variants, batch, seq, steps):
    """The mixers' two- or four-rank run: ``tp_mixers`` (on a model axis
    alone), the CLI on each of ``argvs`` and ``lm_steps`` of each of
    ``variants`` ({name: (arch, config changes)})."""
    out = {"cli": cli_runs(mesh, device, argvs),
           "lm": {n: lm_steps(mesh, device, a, batch, seq, steps, change)
                  for n, (a, change) in variants.items()}}
    if mesh.shape["model"] == mesh.size:
        out["modules"] = tp_mixers(mesh, device)
    return out


def tp_all(mesh, device, argvs, archs, batch, seq, steps):
    """The tensor-parallel tests' two-rank run: ``tp_modules``, the CLI on
    each of ``argvs`` and ``lm_steps`` of each of ``archs``."""
    return {"modules": tp_modules(mesh, device),
            "cli": cli_runs(mesh, device, argvs),
            "lm": {a: lm_steps(mesh, device, a, batch, seq, steps)
                   for a in archs}}


def serve_inputs(arch: str, batch: int, prompt: int, device="cpu"):
    """The smoke ``arch``'s weights, prompt tokens (and an encoder's
    frames) of the fixed serve cases, made from seeds."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    model = LM(get_config(arch, smoke=True))
    params = model.init(prng.PRNGKey(5), device)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, (batch, prompt)).astype(np.int32)).to(device)
    frames = None
    if model.cfg.is_encdec:
        frames = torch.from_numpy(rng.standard_normal(
            (batch, prompt - 3, model.cfg.d_model)).astype(np.float32)).to(
                device)
    return model, params, tokens, frames


def serve_fixed(mesh, device, archs, batch, prompt, gen):
    """The fixed driver (``launch.serve.fixed_generate``) of each smoke
    arch as this rank of ``mesh``: the gathered tokens and cache, the
    cache's layouts (``sharding.cache_layout``) and the collectives
    counted."""
    from repro_torch.distributed import runtime, sharding
    from repro_torch.launch.serve import fixed_generate

    out = {}
    for arch in archs:
        model, params, tokens, frames = serve_inputs(arch, batch, prompt,
                                                     device)
        runtime.reset_stats()
        toks, cache = fixed_generate(model, params, tokens, gen, mesh=mesh,
                                     frames=frames)
        acache = model.init_cache(batch, prompt + gen, device="meta",
                                  enc_len=0 if frames is None
                                  else frames.shape[1])
        out[arch] = {"tokens": toks.cpu(), "cache": _to(cache, "cpu"),
                     "layout": {p: (lay.data, lay.model_dim) for p, lay in
                                sharding.cache_layout(acache, mesh).items()},
                     "stats": {k: dict(v) for k, v in runtime.STATS.items()}}
    return out


def _to(tree, device):
    from repro_torch.core.paths import tree_map_with_path

    host = ("key", "step", "seed_p", "seed_w")
    return tree_map_with_path(
        lambda p, t: t if p.rsplit("/", 1)[-1] in host else t.to(device), tree)


PROGRAMS = {"compress": compress, "bank": bank, "elastic": elastic,
            "cli": cli, "lm_micro": lm_micro, "cli_runs": cli_runs,
            "lm_steps": lm_steps, "tp_modules": tp_modules, "tp_all": tp_all,
            "tp_mixers": tp_mixers, "tp_mixers_all": tp_mixers_all,
            "serve_fixed": serve_fixed}


def main(argv):
    program, rank, world, init_file, out, device, kw = argv
    rank, world = int(rank), int(world)
    kw = json.loads(kw)
    torch.set_num_threads(1)
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_host_mesh

    dev = runtime.init(rank, world, init_file, device=device)
    mesh = make_host_mesh(kw.pop("data", world), kw.pop("model", 1))
    try:
        res = PROGRAMS[program](mesh, dev, **kw)
        torch.save(res, out)
    finally:
        runtime.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
