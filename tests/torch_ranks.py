"""Multi-rank programs of the port's distribution tests, and their launcher.

``run(program, world, workdir, ...)`` starts ``world`` processes of this
module, one per rank (a gloo process group over a rendezvous file in
``workdir``), waits for all of them within ``timeout`` seconds (a hung
collective kills every rank and fails the test) and returns each rank's
result. A program is a function ``(mesh_or_None, device, **kw) -> dict``
of this module's ``PROGRAMS``; each rank's result is ``torch.save``'d.
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
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, f"rdzv_{program}_{time.time_ns()}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        out = os.path.join(workdir, f"{program}_rank{r}.pt")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "torch_ranks", program, str(r), str(world),
             init_file, out, device, json.dumps(kw)],
            env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for _, p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            stdout, stderr = p.communicate(timeout=left)
            logs.append(stdout + stderr)
    except subprocess.TimeoutExpired:
        for _, p in procs:
            p.kill()
        raise AssertionError(f"{program} on {world} ranks did not finish in "
                             f"{timeout} s")
    bad = [r for r, (_, p) in enumerate(procs) if p.returncode != 0]
    assert not bad, (f"{program}: ranks {bad} failed; rank {bad[0]}:\n"
                     + logs[bad[0]][-3000:])
    return [torch.load(out, weights_only=False) for out, _ in procs]


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
         state_file=""):
    """Init under the mesh (specs, bytes per rank), then ``steps`` steps
    from the whole state in ``state_file`` (or from that init), gathered;
    rank 0 also runs the one-process steps from the same state."""
    from repro_torch import prng
    from repro_torch.core.paths import flatten_with_path, leaves
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
    batch = bank_batch(kind, device)
    ops.reset_launch_counts()
    metrics = []
    for _ in range(steps):
        state, m = tr.train_step(state, batch)
        metrics.append({k: v.cpu() for k, v in m.items()})
    launches = ops.LAUNCHES["analog_update"]
    bank_ = state["tiles"]
    out = {"names": [g for g, _ in getattr(bank_, "index", ())],
           "classes": [c for c, _ in getattr(bank_, "class_index", ())],
           "specs": specs, "total": total, "per_rank": per_rank,
           "shapes_ok": shapes_ok, "metrics": metrics, "launches": launches,
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

    state, hist = train.main(argv)
    dp = int(argv[argv.index("--data-parallel") + 1])
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else "qwen2-0.5b"
    model = LM(get_config(arch, smoke=True))
    tr = train.make_trainer(model, "erider", True, 1, mesh=mesh)
    tr.abstract_state(model.abstract_params(device), device)
    assert mesh.shape["data"] == dp
    return {"history": hist, "state": _to(gather_tree(state, tr.shardings),
                                          "cpu")}


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


def _to(tree, device):
    from repro_torch.core.paths import tree_map_with_path

    host = ("key", "step", "seed_p", "seed_w")
    return tree_map_with_path(
        lambda p, t: t if p.rsplit("/", 1)[-1] in host else t.to(device), tree)


PROGRAMS = {"compress": compress, "bank": bank, "elastic": elastic,
            "cli": cli, "lm_micro": lm_micro}


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
