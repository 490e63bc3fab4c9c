"""The port's SP-tracking filter (kernel K2) against the JAX package.

* ``ref.sp_filter_ref`` (the plain version of the CUDA kernel) against JAX
  ``ref.sp_filter_ref`` on the same numpy inputs: ``q_new`` bit-equal (both
  divide, op by op), the two sums within ``rtol=1e-6`` (torch and XLA sum
  in other orders), with symmetric and asymmetric ``tau``, q/p in float32
  and bfloat16.
* Against the Pallas kernel in interpret mode: ``atol=1e-6`` on ``q_new``
  and ``rtol=1e-5`` on the sums, the reference's own tolerances (the Pallas
  body multiplies by reciprocals, and the interpreter's jitted code
  contracts multiply-adds).
* ``ops.sp_filter`` against JAX ``ops.sp_filter`` on ragged and rank-3
  inputs (the JAX wrapper pads to blocks; the port does not).
* The CUDA kernel's launch plan (``sp_filter.launch_plan``): blocks, each
  block's range, the 16-byte or the element path and the tail, from the
  size and the operands' alignment.
* The kernel's summation order replayed in torch
  (``sp_filter.sums_in_launch_order``: per thread, each block's tree, then
  the last block's tree over the partials) against JAX
  ``ref.sp_filter_ref`` at ``rtol=1e-6``, and bit-equal to a literal
  thread-by-thread loop over the plan.
* The CUDA kernel against the plain version and the replayed order, on the
  card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sp_filter import sp_filter_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TAUS = {"symmetric": (1.0, 1.0), "asymmetric": (0.7, 1.3)}


def _operands(shape, dtype="float32", seed=0):
    """numpy q, p (rounded to ``dtype``), gamma, rho."""
    rng = np.random.default_rng(seed)
    q = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    p = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    gamma = np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32)
    rho = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return q, p, gamma, rho


def _kw(tau, eta=0.3):
    tau_min, tau_max = TAUS[tau]
    return dict(eta=eta, tau_min=tau_min, tau_max=tau_max)


def _torch(o, dtype="float32"):
    q, p, gamma, rho = (torch.from_numpy(a) for a in o)
    return q.to(TDT[dtype]), p.to(TDT[dtype]), gamma, rho


@pytest.mark.parametrize("shape", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("tau", list(TAUS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_filter_ref_matches_jax_ref(shape, tau, dtype):
    o = _operands(shape, dtype)
    q_new, gp, err = ref.sp_filter_ref(*_torch(o, dtype), **_kw(tau))
    assert q_new.dtype == TDT[dtype] and q_new.shape == shape
    assert gp.dtype == err.dtype == torch.float32 and gp.ndim == err.ndim == 0
    jq, jp, jg, jr = (jnp.asarray(a) for a in o)
    want = jref.sp_filter_ref(jq.astype(dtype), jp.astype(dtype), jg, jr,
                              **_kw(tau))
    np.testing.assert_array_equal(q_new.float().numpy(),
                                  np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("tau", list(TAUS))
def test_sp_filter_ref_matches_pallas_interpret(shape, tau):
    o = _operands(shape, seed=1)
    q_new, gp, err = ref.sp_filter_ref(*_torch(o), **_kw(tau))
    want = sp_filter_pallas(*(jnp.asarray(a) for a in o), interpret=True,
                            **_kw(tau))
    np.testing.assert_allclose(q_new.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-5)


@pytest.mark.parametrize("shape", [(33, 97), (3, 33, 97), (50,)])
def test_ops_matches_jax_ops_on_ragged_shapes(shape):
    o = _operands(shape, seed=2)
    kw = _kw("asymmetric", eta=0.1)
    before = dict(ops.LAUNCHES)
    q_new, gp, err = ops.sp_filter(*_torch(o), **kw)
    assert ops.LAUNCHES == before  # the plain path launches nothing
    want = jops.sp_filter(*(jnp.asarray(a) for a in o), **kw)
    assert q_new.shape == shape
    np.testing.assert_array_equal(q_new.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-6)


def test_ops_mixed_dtypes_and_zero_d_sums():
    """bf16 q with f32 p, f64 gamma/rho: the plain path takes them as they
    come; the sums stay 0-d float32 tensors (no host sync)."""
    q, p, gamma, rho = _torch(_operands((2, 3, 4, 5), seed=3))
    q_new, gp, err = ops.sp_filter(q.to(torch.bfloat16), p, gamma.double(),
                                   rho.double(), **_kw("symmetric"))
    assert q_new.dtype == torch.bfloat16 and q_new.shape == (2, 3, 4, 5)
    assert torch.is_tensor(gp) and gp.shape == () and gp.dtype == torch.float32
    assert torch.is_tensor(err) and err.shape == ()


def test_kernel_binding_takes_cuda_tensors_only():
    """The binding never runs the plain version in the kernel's place."""
    from repro_torch.kernels.sp_filter import launch_plan, sp_filter_cuda

    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sp_filter_cuda(x, x, torch.ones_like(x), x, **_kw("symmetric"))
    # the grid depends on the size and the alignment alone, so the sums'
    # order does too
    assert [launch_plan(n, True).blocks for n in
            (0, 1, 1027, 1028, 10 ** 8)] == [1, 1, 1, 2, 132 * 4]
    assert [launch_plan(n, False).blocks for n in
            (0, 1, 256, 257, 10 ** 8)] == [1, 1, 1, 2, 132 * 4]


# size -> (blocks, items, tail) on the 16-byte path, then on the element
# path: the edges of a vector and of a round (THREADS = 256 items), the
# FCN's fc1 tile (784 * 256) and Qwen2-0.5B's MLP tile (896 * 4864)
PLANS = {0: ((1, 0, 0), (1, 0, 0)), 1: ((1, 0, 1), (1, 1, 0)),
         3: ((1, 0, 3), (1, 3, 0)), 4: ((1, 1, 0), (1, 4, 0)),
         5: ((1, 1, 1), (1, 5, 0)), 1023: ((1, 255, 3), (4, 1023, 0)),
         1024: ((1, 256, 0), (4, 1024, 0)), 1025: ((1, 256, 1), (5, 1025, 0)),
         200704: ((196, 50176, 0), (528, 200704, 0)),
         4358144: ((528, 1089536, 0), (528, 4358144, 0))}


@pytest.mark.parametrize("size", list(PLANS))
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_launch_plan(size, aligned):
    from repro_torch.kernels import sp_filter as k

    plan = k.launch_plan(size, aligned)
    blocks, items, tail = PLANS[size][0 if aligned else 1]
    assert (plan.vector, plan.blocks, plan.items, plan.tail) == \
        (aligned, blocks, items, tail)
    assert (k.VEC if aligned else 1) * plan.items + plan.tail == size
    assert plan.chunks == -(-plan.items // k.CHUNK)
    ranges = plan.ranges()
    assert len(ranges) == plan.blocks <= k.MAX_BLOCKS
    # contiguous runs of whole chunks (the last one cut at the end) that
    # cover the items once, in order, none empty unless there is nothing to
    # do, one chunk apart but for the cut
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s % k.CHUNK == 0 for s, _ in ranges)
    sizes = [e - s for s, e in ranges]
    assert all(n > 0 for n in sizes) or plan.items == 0
    assert max(sizes) - min(sizes) < 2 * k.CHUNK


@pytest.mark.parametrize("dtype,offset,aligned", [
    (torch.float32, 0, True), (torch.float32, 1, False),
    (torch.float32, 2, False), (torch.float32, 4, True),
    (torch.bfloat16, 0, True), (torch.bfloat16, 2, False),
    (torch.bfloat16, 4, True)])
def test_vector_alignment_of_views(dtype, offset, aligned):
    """A contiguous view at a storage offset is vector-aligned only at a
    whole vector (16 bytes in f32, 8 in bf16); ``.contiguous()`` keeps the
    offset, so the kernel must take such views on its element path."""
    from repro_torch.kernels.sp_filter import vector_aligned

    base = torch.zeros(64, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 40]
    assert view.contiguous().data_ptr() == view.data_ptr()
    assert vector_aligned(view) is aligned
    assert vector_aligned(base, view) is aligned


def _literal_sums(g2, d2, plan):
    """The kernel's order, one thread at a time, in numpy float32."""
    from repro_torch.kernels import sp_filter as k

    vec = k.VEC if plan.vector else 1
    f32 = np.float32

    def tree(vals):
        vals = [f32(v) for v in vals]
        warps = []
        for w in range(k.THREADS // 32):
            lanes = vals[32 * w:32 * w + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = [f32(lanes[i] + lanes[i + off]) for i in range(off)]
            warps.append(lanes[0])
        off = len(warps) // 2
        while off:
            warps = [f32(warps[i] + warps[i + off]) for i in range(off)]
            off //= 2
        return warps[0]

    sums = []
    for terms in (g2, d2):
        partials = []
        for b, (start, end) in enumerate(plan.ranges()):
            acc = [f32(0.0)] * k.THREADS
            for t in range(k.THREADS):
                for i in range(start + t, end, k.THREADS):
                    for j in range(vec):
                        acc[t] = f32(acc[t] + terms[i * vec + j])
                if b == plan.blocks - 1 and t < plan.tail:
                    acc[t] = f32(acc[t] + terms[k.VEC * plan.items + t])
            partials.append(tree(acc))
        acc = [f32(0.0)] * k.THREADS
        for b, x in enumerate(partials):
            acc[b % k.THREADS] = f32(acc[b % k.THREADS] + x)
        sums.append(tree(acc))
    return sums


@pytest.mark.parametrize("size", [1, 3, 5, 1025, 5003, 12000])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_sum_order_replay_matches_literal_loop(size, aligned):
    from repro_torch.kernels import sp_filter as k

    o = _torch(_operands((size,), seed=4))
    kw = _kw("asymmetric")
    plan = k.launch_plan(size, aligned)
    got = k.sums_in_launch_order(*o, plan=plan, **kw)
    _, g2, d2 = ref.sp_filter_terms(*o, **kw)
    want = _literal_sums(g2.numpy(), d2.numpy(), plan)
    assert [x.item() for x in got] == [float(x) for x in want]


@pytest.mark.parametrize("shape", [(784, 256), (896, 4864), (33, 97),
                                   (1025,), (3,)])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32")])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_sum_order_replay_matches_jax_ref(shape, dtypes, aligned):
    """The kernel's summation order against XLA's: the sums within
    ``rtol=1e-6`` on both of the kernel's paths, any mix of q/p dtypes."""
    from repro_torch.kernels import sp_filter as k

    qd, pd = dtypes
    o = _operands(shape, "bfloat16", seed=5)
    q, p, gamma, rho = _torch(o)
    q, p = q.to(TDT[qd]), p.to(TDT[pd])
    kw = _kw("asymmetric", eta=0.2)
    gp, err = k.sums_in_launch_order(
        q, p, gamma, rho, plan=k.launch_plan(q.numel(), aligned), **kw)
    jq, jp, jg, jr = (jnp.asarray(a) for a in o)
    want = jref.sp_filter_ref(jq.astype(qd), jp.astype(pd), jg, jr, **kw)
    assert gp.dtype == err.dtype == torch.float32 and gp.ndim == 0
    np.testing.assert_allclose(float(gp), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-6)

