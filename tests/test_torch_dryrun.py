"""The port's per-rank dry run (``repro_torch.launch.dryrun``) against the
JAX package's: MODEL_FLOPS for every arch x shape, the per-rank argument
bytes of train and decode cells on the mini meshes against the sum of
JAX's ``NamedSharding.shard_shape`` bytes (``jax.eval_shape`` in one
subprocess on 8 fake XLA devices, nothing compiled), the replay of
``test_mini_dryrun_subprocess`` (the train cells traced: status "ok",
flops > 0; the decode cells "args_only"), and the tile-state bytes the
card measured."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.benchmarks.step_profile import cut_depth
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM
from repro_torch.roofline import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
         ("mamba2-2.7b", "train_4k"), ("mamba2-2.7b", "long_500k"),
         ("minicpm3-4b", "train_4k"), ("minicpm3-4b", "decode_32k")]

JAX_BYTES = textwrap.dedent("""
    import json, os, sys
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    from repro.launch import dryrun  # pins 8 host devices
    import jax, numpy as np
    from repro.configs import SHAPES, get_config, input_specs
    from repro.core.paths import path_str
    from repro.distributed import sharding
    from repro.launch.mesh import make_mesh
    from repro.models.lm import LM

    HOST = ("key", "step", "seed_p", "seed_w")

    def nbytes(tree, shardings):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        shs = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
        total = 0
        for (kp, leaf), sh in zip(leaves, shs):
            if path_str(kp).split("/")[-1] in HOST:
                continue
            total += (int(np.prod(sh.shard_shape(leaf.shape)))
                      * np.dtype(leaf.dtype).itemsize)
        return total

    out = {}
    for mname, (shape, axes) in json.loads(sys.argv[1]).items():
        mesh = make_mesh(tuple(shape), tuple(axes))
        _, dsize, _, _ = sharding.mesh_axis_sizes(mesh)
        for arch, shape_name in json.loads(sys.argv[2]):
            cfg = get_config(arch)
            spec = SHAPES[shape_name]
            model = LM(cfg)
            aparams = model.abstract_params()
            batch = input_specs(cfg, shape_name)
            if spec.kind == "train":
                tr = dryrun.make_trainer(model, arch, "erider", dsize,
                                         mesh=mesh)
                st = tr.abstract_state(aparams)
                n = (nbytes(st, sharding.state_shardings(st, mesh,
                                                         zero_states=True))
                     + nbytes(batch, sharding.batch_shardings(batch, mesh)))
            else:
                enc = min(spec.seq_len, 32768) if cfg.is_encdec else 0
                cache = model.init_cache(spec.global_batch, spec.seq_len,
                                         enc_len=enc, abstract=True)
                tok = {"t": batch["tokens"]}
                n = (nbytes(aparams, sharding.params_shardings(aparams, mesh))
                     + nbytes(cache, sharding.cache_shardings(cache, mesh))
                     + nbytes(tok, sharding.batch_shardings(tok, mesh))
                     + np.dtype(batch["pos"].dtype).itemsize)
            out[f"{mname}/{arch}/{shape_name}"] = n
    print("BYTES " + json.dumps(out))
""")

MINI_DRYRUN = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    def small_mesh(*, multi_pod=False):
        if multi_pod:
            return make_mesh((2, 2, 2), ("pod", "data", "model"))
        return make_mesh((2, 4), ("data", "model"))

    dryrun.make_production_mesh = small_mesh
    out = {}
    for arch, shape, mp in json.loads(sys.argv[1]):
        r = dryrun.run_cell(arch, shape, multi_pod=mp, out_dir=sys.argv[2],
                            tag="pytest")
        out[f"{arch}/{shape}"] = {k: r.get(k) for k in
                                  ("status", "roofline", "memory", "error",
                                   "k1_records", "ops")}
    print("DRYRUN " + json.dumps(out))
""")

# the reference test's cells (decode_32k multi-pod, long_500k single-pod)
# and the train cells, each train cell in a process of its own
MINI_RUNS = [[["qwen2-0.5b", "train_4k", True],
              ["qwen2-0.5b", "decode_32k", True],
              ["mamba2-2.7b", "long_500k", False]],
             [["mamba2-2.7b", "train_4k", False]]]


def _env(jax_side: bool):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if jax_side:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _collect(proc, tag, timeout):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert line, out[-3000:] + err[-3000:]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the port's mini dry runs, started together."""
    pytest.importorskip("jax")
    out_dir = str(tmp_path_factory.mktemp("dry"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_BYTES, json.dumps(MESHES),
         json.dumps(CELLS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(True), cwd=ROOT)]
    for cells in MINI_RUNS:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MINI_DRYRUN, json.dumps(cells), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(False), cwd=ROOT))
    try:
        jax_bytes = _collect(procs[0], "BYTES", 600)
        mini = {}
        for p in procs[1:]:
            mini.update(_collect(p, "DRYRUN", 600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return jax_bytes, mini


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_jax(arch):
    janalysis = pytest.importorskip("repro.roofline.analysis")
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget

    for name in sorted(SHAPES):
        assert analysis.model_flops_for(get_config(arch), SHAPES[name]) \
            == janalysis.model_flops_for(jget(arch), JSHAPES[name]), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_argument_bytes_match_jax_shards(runs, mesh_name):
    jax_bytes, _ = runs
    shape, axes = MESHES[mesh_name]
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, axes)
    for arch, shape_name in CELLS:
        cell = dryrun.build_cell(arch, shape_name, mesh, build_state=False)
        want = jax_bytes[f"{mesh_name}/{arch}/{shape_name}"]
        assert cell.argument_bytes == want, (arch, shape_name)


def test_mini_dryrun_cells(runs):
    """The replay of the reference's ``test_mini_dryrun_subprocess``."""
    _, mini = runs
    for key in ("qwen2-0.5b/train_4k", "mamba2-2.7b/train_4k"):
        r = mini[key]
        assert r["status"] == "ok", r
        assert r["roofline"]["hlo_flops"] > 0
        assert r["roofline"]["model_flops"] > 0
        assert r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"] > 0
        assert r["k1_records"] > 0 and r["ops"] > 0
    for key in ("qwen2-0.5b/decode_32k", "mamba2-2.7b/long_500k"):
        r = mini[key]
        assert r["status"] == "args_only", r
        assert r["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch, layers, mesh, want", [
    ("qwen2-0.5b", 0, None, 2863178304),
    ("qwen2-0.5b", 0, (2, 1), 1431589440),
    ("minicpm3-4b", 4, (1, 2), 1798259408),
])
def test_tile_state_bytes_match_the_card(arch, layers, mesh, want):
    """The CLI trainer's tile state, a rank, as ``chip_smoke.py`` measured
    it on the card (PERF.md: phase 10a, 15, 17)."""
    model = LM(cut_depth(get_config(arch), layers))
    m = make_host_mesh(*mesh) if mesh else None
    tr = train.make_trainer(model, "erider", False, 8, mesh=m)
    st = tr.abstract_state(model.abstract_params("meta"), "meta")
    shardings = tr.shardings["tiles"] if m is not None else None
    assert dryrun.leaf_bytes(st["tiles"], shardings, m,
                             device_only=False) == want
