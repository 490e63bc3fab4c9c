"""The port's op-trace cost model: its flop table against
``torch.utils.flop_counter.FlopCounterMode`` on the smoke train and serve
steps, each kernel one record priced at its ``PERF.md`` bytes, the
memory and collective accounting, and the roofline against the JAX
package's formulas."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import prng
from repro_torch.analysis import graph_contracts as gc
from repro_torch.configs import get_config
from repro_torch.distributed import runtime
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM
from repro_torch.roofline import analysis, op_cost
from repro_torch.roofline.op_cost import OpTrace, analyze_trace, record_bytes

META = torch.device("meta")
KW = dict(dw_min=1e-4, tau_min=1.0, tau_max=1.0, sigma_c2c=0.05)


def _flops_both(call):
    """(port table's flops without the kernels' ops, FlopCounterMode's)."""
    with OpTrace() as tr, FlopCounterMode(display=False) as fc:
        call()
    mine = sum(f for f, r in zip(tr.flops, tr.records)
               if r.name not in op_cost.KERNEL_OPS)
    return mine, fc.get_total_flops(), tr


def test_flops_match_flop_counter_on_the_smoke_train_step():
    cfg = get_config("qwen2-0.5b", smoke=True)
    model = LM(cfg)
    trainer = train.make_trainer(model, "erider", True, 10)
    state = gc._to_device(trainer.init(prng.PRNGKey(1),
                                       model.init(prng.PRNGKey(0), "cpu")),
                          META)
    batch = {k: torch.zeros((2, 16), dtype=torch.int32, device=META)
             for k in ("tokens", "labels")}
    mine, want, tr = _flops_both(lambda: trainer.train_step(state, batch))
    assert want > 0 and mine == want
    # the pulse update: one K1 record per analog array, none of its math
    assert len(tr.kernel_records("analog_update")) == 2 * sum(
        len(ps) for _, ps in state["tiles"].index)


@pytest.mark.parametrize("name", ["serve_step_lanes", "prefill_commit_batch",
                                  "prefill_commit"])
def test_flops_match_flop_counter_on_the_serve_steps(name):
    call, _ = gc.ENTRYPOINTS[name](None, META)
    mine, want, _ = _flops_both(call)
    assert want > 0 and mine == want


# ---------------------------------------------------------------------------
# the kernels: one record each, priced by shape
# ---------------------------------------------------------------------------


def _k1(shape, wdtype, device):
    w = torch.zeros(shape, dtype=wdtype, device=device)
    dw = torch.zeros(shape, device=device)
    g = torch.ones(shape, device=device)
    return w, dw, g, torch.zeros(shape, device=device)


@pytest.mark.parametrize("wdtype, per_elem", [(torch.float32, 28),
                                              (torch.bfloat16, 24)])
def test_k1_priced_at_its_bound_bytes(wdtype, per_elem):
    """``per_elem``: the operand mode's bytes (noise given); the hash-noise
    mode (``rng="hash"``, no noise) reads no noise, 8 B an element less,
    and one (1, 2) int32 seed."""
    shape = (24, 896, 4864)
    w, dw, g, r = _k1(shape, wdtype, META)
    noise = (torch.zeros(shape, dtype=torch.int32, device=META),
             torch.zeros(shape, device=META))
    with OpTrace() as tr:
        out = ops.analog_update(w, dw, g, r, prng.PRNGKey(3), rng="hash", **KW)
        ops.analog_update(w, dw, g, r, None, noise=noise, **KW)
    assert out.shape == shape and out.dtype == wdtype
    hashed, operand = tr.kernel_records("analog_update")
    assert hashed.name == "repro_torch.analog_update_hash.default"
    assert record_bytes(hashed) == (per_elem - 8) * w.numel() + 8
    assert record_bytes(operand) == per_elem * w.numel()
    assert op_cost.element_ops(hashed) == 114 * w.numel()
    assert op_cost.element_ops(operand) == 30 * w.numel()


def test_hash_normal_priced_at_its_bound_bytes():
    """4 B an element written, 8 B a seed read; one record a draw."""
    from repro_torch.kernels import fastrng

    seeds = torch.tensor([[1, 2], [3, 4], [5, 6]])
    with OpTrace() as tr:
        z = fastrng.hash_normal(seeds, (896, 4864), 11, META)
    assert z.shape == (3, 896, 4864) and z.dtype == torch.float32
    (rec,) = tr.kernel_records("hash_normal")
    assert record_bytes(rec) == 4 * z.numel() + 3 * 8
    assert op_cost.element_ops(rec) == 62 * z.numel()
    assert [x.upload_bytes for x in tr.records if x.upload_bytes] == [24]


def test_k2_priced_at_its_bound_bytes():
    shape = (896, 4864)
    q, p, g, r = (torch.zeros(shape, device=META) for _ in range(4))
    with OpTrace() as tr:
        q_new, gp, err = ops.sp_filter(q, p, g, r, eta=0.5, tau_min=1.0,
                                       tau_max=1.0)
    assert q_new.shape == shape and gp.shape == () and err.shape == ()
    (rec,) = tr.kernel_records("sp_filter")
    assert record_bytes(rec) == 20 * q.numel() + 8  # + the two f32 sums


def test_k3_priced_at_6mnk():
    m, k, n = 2048, 896, 4864
    x = torch.zeros((m, k), device=META)
    w = torch.zeros((k, n), device=META)
    io = dict(inp_res=1 / 127, inp_bound=1.0, out_res=1 / 511,
              out_bound=12.0, out_noise=0.06)
    with OpTrace() as tr:
        y = ops.analog_mvm(x, w, None, noise=torch.zeros((m, n), device=META),
                           **io)
    assert y.shape == (m, n)
    (rec,) = tr.kernel_records("analog_mvm")
    i = tr.records.index(rec)
    assert tr.flops[i] == 6 * m * n * k
    assert analyze_trace(tr).flops == 6 * m * n * k


def test_each_kernel_call_is_one_record_on_the_cpu():
    """On the CPU the op runs the plain version, whose operations the trace
    does not see: one record under the kernel's name."""
    w, dw, g, r = _k1((8, 16), torch.float32, "cpu")
    noise = (torch.zeros((8, 16), dtype=torch.int64), torch.zeros((8, 16)))
    with OpTrace() as tr:
        ops.analog_update(w, dw, g, r, None, noise=noise, **KW)
    assert [x.name for x in tr.records] == ["repro_torch.analog_update.default"]
    with OpTrace() as tr:
        ops.sp_filter(w, dw, g, r, eta=0.5, tau_min=1.0, tau_max=1.0)
    assert tr.records[0].name == "repro_torch.sp_filter.default"
    assert len(tr.kernel_records("sp_filter")) == 1
    assert all(x.name in op_cost.FREE_OPS for x in tr.records[1:])


# ---------------------------------------------------------------------------
# memory and collectives
# ---------------------------------------------------------------------------


def test_bytes_are_operands_plus_results_and_views_are_free():
    x = torch.zeros((4, 8), device=META)
    with OpTrace() as tr:
        y = x + 1.0
        y.view(32)
        torch.mm(x, x.t())
    cost = analyze_trace(tr)
    add = 128 + 128
    mm = 128 + 128 + 64
    assert cost.bytes == add + mm
    assert cost.flops == 2 * 4 * 4 * 8


def test_peak_of_live_storages():
    x = torch.zeros(100, device=META)  # made before the trace: not counted
    with OpTrace(round_bytes=512) as tr:
        a = x + 1          # 400 B -> 512
        b = a * 2          # 512 live + 512
        del a              # released
        c = b + 1
        a = b.view(10, 10)  # a view makes nothing
        b.add_(1)           # in place makes nothing
        del c
    assert tr.peak_bytes == 1024
    assert tr.live_bytes == 512  # b
    assert tr.written == {b.untyped_storage()._cdata}
    del a, b


@torch.library.custom_op("repro_torch_test::grow", mutates_args=())
def _grow(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(int(n))


@_grow.register_fake
def _(x, n):
    # a meta result whose shape is the value of a 0-d CPU tensor
    return x.new_empty(int(n))


def test_memo_keys_a_cpu_scalar_by_its_value():
    x = torch.zeros(4, device=META)
    with OpTrace() as tr:
        a = _grow(x, torch.tensor(3))
        b = _grow(x, torch.tensor(5))
    assert (a.shape, b.shape) == ((3,), (5,))
    assert [r.outputs[0].shape for r in tr.records
            if r.name.startswith("repro_torch_test")] == [(3,), (5,)]


@pytest.mark.parametrize("name", ["train_step_scanned", "serve_step_lanes"])
def test_memo_changes_no_record(name):
    """A step traced with the memo and without it: the same records, flops,
    bytes and peak."""
    def trace(memo):
        call, _ = gc.ENTRYPOINTS[name](None, META)
        with OpTrace(round_bytes=512, memo=memo) as tr:
            call()
        return tr

    fast, slow = trace(True), trace(False)
    assert fast.records == slow.records and fast.flops == slow.flops
    assert analyze_trace(fast).bytes == analyze_trace(slow).bytes
    assert fast.peak_bytes == slow.peak_bytes


def test_collective_bytes_from_the_abstract_runtime():
    mesh = make_host_mesh(2, 2)
    t = torch.zeros((4, 8), device=META)
    with runtime.abstract(mesh, 3), OpTrace() as tr:
        g = runtime.all_gather(t, mesh.group("data"), dim=0, label="ag")
        s = runtime.all_reduce(t, mesh.group("model"), label="ar")
        assert mesh.coords() == {"data": 1, "model": 1}
        assert mesh.group("data").ranks == (1, 3)
    assert g.shape == (8, 8) and g.device.type == "meta"
    assert s.shape == t.shape
    with pytest.raises(RuntimeError, match="process group"):
        mesh.coords()  # nothing changes outside the context
    assert analyze_trace(tr).coll == {"ag": 128, "ar": 128}
    assert analyze_trace(tr).coll_bytes == 256


# ---------------------------------------------------------------------------
# the roofline: the JAX package's fields and formulas, the H100's constants
# ---------------------------------------------------------------------------


def test_roofline_formulas_match_jax():
    janalysis = pytest.importorskip("repro.roofline.analysis")
    kw = dict(arch="a", shape="s", mesh="m", chips=8, hlo_flops=3e15,
              hlo_bytes=2e13, coll_bytes=5e11, coll_breakdown={"x": 1},
              model_flops=1e15, bytes_per_device=1e9,
              args_bytes_per_device=1e8)
    mine, ref = analysis.Roofline(**kw), janalysis.Roofline(**kw)
    assert set(mine.to_json()) == set(ref.to_json())
    for name, const in (("t_compute", "PEAK_FLOPS"), ("t_memory", "HBM_BW"),
                        ("t_collective", "LINK_BW")):
        scale = getattr(janalysis, const) / getattr(analysis, const)
        assert getattr(mine, name) == pytest.approx(getattr(ref, name) * scale)
    assert mine.useful_ratio == ref.useful_ratio
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) \
        == (989e12, 3.35e12, 450e9)
    cost = op_cost.Cost(flops=1e12, bytes=1e10, coll={"ag": 4.0})
    r = analysis.analyze(arch="a", shape="s", mesh_name="m", chips=4,
                         cost=cost, model_flops=2e12)
    assert (r.hlo_flops, r.hlo_bytes, r.coll_bytes) == (4e12, 4e10, 16.0)
    assert r.bottleneck == "memory"
