"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX (the other ``test_torch_*`` files hold the plain
versions to the JAX package on the CPU), so it runs on a machine that has
the card and PyTorch alone:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

* K1 ``ops.analog_update``: bit-equal to the plain version.
* K3 ``ops.analog_mvm``: within one ADC step (``out_res * s`` of the row,
  plus the rounding of the output to its dtype: four float32 ULPs or one
  bfloat16 ULP of the value) and at least 99.9 % bit-equal; the plain
  version's cuBLAS product sums in another order, which can move y across
  an ADC rounding boundary. Its DAC prologue's codes and row scale are
  bit-equal to ``ref.dac_codes``.
* K2 ``ops.sp_filter``: ``q_new`` bit-equal, the sums within ``rtol=1e-5``,
  bit-identical from run to run and bit-equal to the kernel's summation
  order replayed in torch (``sp_filter.sums_in_launch_order``), for every
  mix of q/p dtypes, views at storage offsets (the element path), sizes
  around a vector and a group, and calls replayed from a CUDA graph.
Each wrapper call launches its kernel once.

* Checkpoints, data and lifetime on the card: a trained state saved from
  the card restores into ``abstract_state(device="cuda")`` bit for bit and
  resumes bit-exactly; ``Prefetcher(device="cuda")`` places batches on the
  card; age 0 and GDC at t0 are bit-exact, and one year of drift on the
  card agrees with the CPU within ``rtol=4e-6`` + ``1e-6 * amax|w|``.
  Signatures taken on the card and checked on the CPU sum in another
  order: alpha is held within 1e-6 of 1, not to exactly 1.
* The LM training path: K1 bit-equal on a stacked bfloat16 tile with
  float32 dw and hash noise; the smoke LM's logits on the card within 2e-6
  of their largest magnitude of the CPU's; two CLI steps on the card with
  two kernel launches per analog path per step.
* The rest of the LM zoo (MoE, MLA, RG-LRU, SSD, enc-dec): each smoke
  LM's logits and MoE aux loss on the card within 2e-6 of the CPU's (320
  tokens: MoE's einsum dispatch; 128: its gather dispatch); the gathers of
  the model path (the embedding read, MoE's expert selection and ragged
  permutations, SSD's head repeat) give bit-identical gradients from run
  to run on the card, where ``F.embedding`` and ``index_select`` with
  repeated ids add with atomics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see README)")


def _card(arrays, dtypes):
    """numpy arrays -> tensors on the card, each cast to its dtype name."""
    return [torch.from_numpy(a).cuda().to(TDT[d]) for a, d in zip(arrays, dtypes)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (300, 700), (4, 300, 700)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analog_update_kernel_matches_plain(cuda, shape, dtype):
    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=10)
    rng = np.random.default_rng(0)
    w, dw, gamma, rho, zeta = _card(
        [rng.uniform(-0.8, 0.8, shape).astype(np.float32),
         (0.05 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32),
         rng.standard_normal(shape).astype(np.float32)],
        [dtype, dtype, "float32", "float32", "float32"])
    ubits = torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        .astype(np.int64)).cuda()
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(w, dw, gamma, rho, None, noise=(ubits, zeta), **kw)
    assert ops.backend(w) == "cuda"
    assert ops.LAUNCHES["analog_update"] == before + 1
    want = ref.analog_update_ref(w, dw, gamma, rho, ubits, zeta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


IO = dict(inp_res=1 / 126, inp_bound=1.0, out_res=1 / 510, out_bound=12.0,
          out_noise=0.06)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 784), (33, 47), (5, 1), (2048, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dac_codes_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.analog_matmul import dac_codes_cuda

    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    x[1 % shape[0]] = 0.0  # a zero row: s is the 1e-12 floor
    (x,) = _card([x], [dtype])
    codes, s = dac_codes_cuda(x, inp_res=IO["inp_res"],
                              inp_bound=IO["inp_bound"])
    want_codes, want_s = ref.dac_codes(x, IO["inp_res"], IO["inp_bound"])
    torch.cuda.synchronize()
    assert codes.dtype == torch.bfloat16 and codes.shape == x.shape
    assert torch.equal(s, want_s)
    assert torch.equal(codes.float(), want_codes)


# the reference tests' products, ragged K (1, 47), M not a multiple of 16,
# and shapes that take each of the kernel's three tile sizes
@pytest.mark.cuda
@pytest.mark.parametrize("xshape,wshape", [((64, 128), (128, 96)),
                                           ((5, 33, 47), (47, 29)),
                                           ((17, 1), (1, 40)),
                                           ((37, 200), (200, 130)),
                                           ((64, 784), (784, 256)),
                                           ((512, 896), (896, 1024)),
                                           ((1024, 256), (256, 1024)),
                                           ((2048, 96), (96, 1536))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "f32x-bf16w"])
def test_analog_mvm_kernel_matches_plain(cuda, xshape, wshape, dtype):
    xd, wd = (("float32", "bfloat16") if dtype == "f32x-bf16w"
              else (dtype, dtype))
    rng = np.random.default_rng(1)
    x, w = _card([rng.standard_normal(xshape).astype(np.float32),
                  (0.1 * rng.standard_normal(wshape)).astype(np.float32)],
                 [xd, wd])
    dtype = xd
    m, n = x.numel() // xshape[-1], wshape[1]
    noise = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).cuda()
    before = ops.LAUNCHES["analog_mvm"]
    got = ops.analog_mvm(x, w, None, noise=noise, **IO)
    assert ops.LAUNCHES["analog_mvm"] == before + 1
    assert got.dtype == x.dtype and tuple(got.shape) == (*xshape[:-1], n)
    x2 = x.reshape(m, -1)
    want = ref.analog_mvm_ref(x2, w, noise, **IO)
    torch.cuda.synchronize()
    got, want = got.reshape(m, n).float(), want.float()
    tol = IO["out_res"] * ref.abs_max_scale(x2) + want.abs() * (
        2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -21)
    assert bool(((got - want).abs() <= tol).all())
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_analog_mvm_kernel_refuses_codes_bfloat16_cannot_hold(cuda):
    from repro_torch.kernels.analog_matmul import analog_mvm_cuda

    x, w, noise = (torch.zeros(4, 8, device="cuda"),
                   torch.zeros(8, 3, device="cuda"),
                   torch.zeros(4, 3, device="cuda"))
    with pytest.raises(ValueError, match="exact in bfloat16"):
        analog_mvm_cuda(x, w, noise, **dict(IO, inp_res=1 / 512))
    before = ops.LAUNCHES["analog_mvm"]
    with pytest.raises(ValueError, match="exact in bfloat16"):
        ops.analog_mvm(x, w, None, noise=noise, **dict(IO, inp_bound=3.0))
    assert ops.LAUNCHES["analog_mvm"] == before


# q/p dtype pairs of K2: as named, then the mixed pairs
SP_DTYPES = {"float32": ("float32", "float32"),
             "bfloat16": ("bfloat16", "bfloat16"),
             "f32q-bf16p": ("float32", "bfloat16"),
             "bf16q-f32p": ("bfloat16", "float32")}
SP_KW = dict(eta=0.3, tau_min=0.7, tau_max=1.3)


def _sp_operands(n, dtypes, seed, offset=0):
    """q, p (in ``dtypes``), gamma, rho: (n,) views at element ``offset``
    of their own buffers on the card (each view stays contiguous)."""
    rng = np.random.default_rng(seed)
    full = _card(
        [(0.1 * rng.standard_normal(n + offset)).astype(np.float32),
         (0.2 * rng.standard_normal(n + offset)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(n + offset)).astype(np.float32),
         (0.3 * rng.standard_normal(n + offset)).astype(np.float32)],
        [*dtypes, "float32", "float32"])
    return [t[offset:] for t in full]


def _sp_check(q, p, gamma, rho, aligned=None):
    """Two wrapper calls against the plain version and the replayed order:
    q_new bit-equal, sums within rtol 1e-5, bit-identical between the calls
    and to ``sums_in_launch_order`` under the binding's plan."""
    from repro_torch.kernels import sp_filter as k

    before = ops.LAUNCHES["sp_filter"]
    q_new, gp, err = ops.sp_filter(q, p, gamma, rho, **SP_KW)
    again = ops.sp_filter(q, p, gamma, rho, **SP_KW)
    assert ops.LAUNCHES["sp_filter"] == before + 2
    want = ref.sp_filter_ref(q, p, gamma, rho, **SP_KW)
    is_aligned = k.vector_aligned(q, p, gamma, rho)
    if aligned is not None:
        assert is_aligned is aligned
    order = k.sums_in_launch_order(
        q, p, gamma, rho, plan=k.launch_plan(q.numel(), is_aligned), **SP_KW)
    torch.cuda.synchronize()
    assert q_new.dtype == q.dtype and q_new.shape == q.shape
    assert gp.shape == () and gp.dtype == torch.float32
    assert torch.equal(q_new, want[0])
    assert torch.equal(q_new, again[0])
    assert torch.equal(gp, again[1]) and torch.equal(err, again[2])
    assert torch.equal(gp, order[0]) and torch.equal(err, order[1])
    torch.testing.assert_close(gp, want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(err, want[2], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 97), (3, 33, 97), (784, 256),
                                   (896, 4864)])
@pytest.mark.parametrize("dtype", list(SP_DTYPES))
def test_sp_filter_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(2)
    q, p, gamma, rho = _card(
        [(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.2 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32)],
        [*SP_DTYPES[dtype], "float32", "float32"])
    _sp_check(q, p, gamma, rho, aligned=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 5, 1025])
@pytest.mark.parametrize("dtype", list(SP_DTYPES))
def test_sp_filter_kernel_small_and_ragged_sizes(cuda, n, dtype):
    """Sizes around one vector and one block: the tail of size % 4
    elements in the last block, and the empty call (sums 0)."""
    _sp_check(*_sp_operands(n, SP_DTYPES[dtype], 3), aligned=True)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 1025, 784 * 256])
@pytest.mark.parametrize("dtype", ["float32", "bf16q-f32p"])
def test_sp_filter_kernel_on_offset_views(cuda, offset, n, dtype):
    """Contiguous views at a storage offset are not 16-byte aligned, and
    ``.contiguous()`` does not realign them: the kernel walks them element
    by element."""
    ops_ = _sp_operands(n, SP_DTYPES[dtype], 4, offset)
    _sp_check(*ops_, aligned=False)
    # one operand off the vector grid is enough to take the element path
    q, p, gamma, rho = _sp_operands(n, SP_DTYPES[dtype], 5)
    _sp_check(q, p, gamma, ops_[3], aligned=False)


@pytest.mark.cuda
def test_sp_filter_kernel_replayed_from_a_cuda_graph(cuda):
    """Three calls captured in one graph and replayed twice give the eager
    calls' results: the kernel puts its ticket back to 0 itself."""
    o = _sp_operands(784 * 256, SP_DTYPES["float32"], 6)
    kws = [dict(SP_KW, eta=eta) for eta in (0.1, 0.3, 0.5)]
    eager = [ops.sp_filter(*o, **kw) for kw in kws]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.sp_filter(*o, **kws[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [ops.sp_filter(*o, **kw) for kw in kws]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# checkpoints, data and lifetime on the card
# ---------------------------------------------------------------------------


def _small_trainer():
    from repro_torch.core.device import PRESETS
    from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig
    from repro_torch.core.plan import AnalogPlan, TilePolicy
    from repro_torch.core.tile import TileConfig
    from repro_torch.core.trainer import AnalogTrainer, TrainerConfig

    dev = PRESETS["pcm_gst"]
    tile = TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                      update_backend="fused")
    return AnalogTrainer(
        lambda p, b, r: (sum(torch.sum(v ** 2) for _, v in sorted(p.items())),
                         {}),
        TrainerConfig(digital=DigitalOptConfig(kind="sgdm"),
                      schedule=ScheduleConfig(kind="constant", base_lr=0.1)),
        plan=AnalogPlan.of(("**", TilePolicy(tile, name="pcm"))))


def _flat_equal(a, b):
    from repro_torch.core.paths import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), p


@pytest.mark.cuda
def test_checkpoint_on_the_card_restores_and_resumes_bit_exactly(cuda, tmp_path):
    from repro_torch import prng
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.paths import TensorSpec, flatten_with_path

    tr = _small_trainer()
    params = {"w": 0.1 * torch.ones(64, 48, device="cuda"),
              "v": 0.2 * torch.ones(64, 48, device="cuda"),
              "b": torch.ones(48, device="cuda")}
    state, _ = tr.train_step(tr.init(prng.PRNGKey(0), params), None)
    ckpt.save(state, str(tmp_path), step=1)
    template = tr.abstract_state(
        {k: TensorSpec(v.shape, v.dtype, "cuda") for k, v in params.items()})
    back = ckpt.restore(template, str(tmp_path), verify=True)
    for p, v in flatten_with_path(back):
        host = p.rsplit("/", 1)[-1] in ("key", "step", "seed_p", "seed_w")
        assert v.device.type == ("cpu" if host else "cuda"), p
    _flat_equal(back, state)
    _flat_equal(tr.train_step(back, None)[0], tr.train_step(state, None)[0])


@pytest.mark.cuda
def test_prefetcher_places_batches_on_the_card(cuda):
    from repro_torch.data import Prefetcher

    pf = Prefetcher(lambda s: {"x": np.full((4, 3), s, np.float32)},
                    start_step=2, device="cuda")
    for s in (2, 3, 4):
        b = next(pf)
        assert b["x"].is_cuda and float(b["x"][0, 0]) == s
    pf.close()


@pytest.mark.cuda
def test_lifetime_on_the_card(cuda):
    from repro_torch import prng
    from repro_torch.core.device import PRESETS
    from repro_torch.lifetime import apply_lifetime, correct_params, signature_tree

    pcm = PRESETS["pcm_gst"]
    w = torch.from_numpy((0.05 * np.random.default_rng(1).standard_normal(
        (256, 128))).astype(np.float32))
    key = prng.PRNGKey(3)
    wc = w.cuda()
    assert torch.equal(apply_lifetime(wc, pcm.drift_t0, key, pcm), wc)
    sig = {p: float(v) for p, v in signature_tree({"w": wc}, ("w",)).items()}
    out, alpha = correct_params({"w": wc}, sig)
    assert alpha["w"] == 1.0 and torch.equal(out["w"], wc)
    t = pcm.drift_t0 + 3.1536e7
    got = apply_lifetime(wc, t, key, pcm).cpu()
    want = apply_lifetime(w, t, key, pcm)
    assert not torch.equal(got, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=4e-6,
                               atol=1e-6 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128), (784, 256), (896, 4864)])
def test_gdc_signature_from_the_card_checked_on_the_cpu(cuda, shape):
    from repro_torch.lifetime import correct_params, signature_tree

    w = torch.from_numpy((0.05 * np.random.default_rng(2).standard_normal(
        shape)).astype(np.float32))
    sig = {p: float(v) for p, v in
           signature_tree({"w": w.cuda()}, ("w",)).items()}
    out, alpha = correct_params({"w": w}, sig)
    assert abs(alpha["w"] - 1.0) <= 1e-6, alpha
    np.testing.assert_allclose(out["w"].numpy(), w.numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 96, 160), (4, 200)])
def test_analog_update_kernel_on_a_stacked_bf16_tile(cuda, shape):
    """The LM path's operands: a bf16 stacked tile (the CLI's non-smoke
    state), float32 dw and hash noise; bit-equal to the plain version."""
    from repro_torch import prng

    kw = dict(dw_min=1e-4, tau_min=1.0, tau_max=1.0, sigma_c2c=0.05)
    rng = np.random.default_rng(4)
    w, dw, gamma, rho = _card(
        [rng.uniform(-0.8, 0.8, shape).astype(np.float32),
         (1e-3 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32)],
        ["bfloat16", "float32", "float32", "float32"])
    noise = ops.make_noise(prng.PRNGKey(5), shape, "cuda", "hash")
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(w, dw, gamma, rho, None, noise=noise, **kw)
    assert ops.LAUNCHES["analog_update"] == before + 1
    want = ref.analog_update_ref(w, dw, gamma, rho, *noise, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
def test_lm_forward_on_the_card_matches_the_cpu(cuda):
    """The qwen2 smoke LM (float32) on the card against the CPU from the
    same parameters: logits within 2e-6 of their largest magnitude, loss
    within rtol 1e-6 (cuBLAS sums in another order; TF32 off)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import tree_map
    from repro_torch.models.lm import LM

    assert not torch.backends.cuda.matmul.allow_tf32
    model = LM(get_config("qwen2-0.5b", smoke=True))
    params = model.init(prng.PRNGKey(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with torch.no_grad():
        want, _ = model.forward(params, toks)
        got, _ = model.forward(tree_map(lambda t: t.cuda(), params), toks.cuda())
        loss_cpu, _ = model.loss(params, batch, None)
        loss_card, _ = model.loss(tree_map(lambda t: t.cuda(), params),
                                  {k: v.cuda() for k, v in batch.items()}, None)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 2e-6 * want.abs().max().item(), err
    np.testing.assert_allclose(loss_card.item(), loss_cpu.item(), rtol=1e-6)


@pytest.mark.cuda
def test_train_cli_on_the_card(cuda):
    """Two steps of the smoke LM through the CLI on the card: finite loss,
    two kernel launches per analog path per step (12 paths)."""
    import signal

    from repro_torch.launch import train

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    ops.reset_launch_counts()
    try:
        state, hist = train.main(["--smoke", "--steps", "2", "--batch", "2",
                                  "--seq", "16", "--log-every", "1",
                                  "--tiles", "full"])
    finally:  # the CLI's PreemptionHandler took them
        for s, h in saved.items():
            signal.signal(s, h)
    assert ops.LAUNCHES["analog_update"] == 2 * 12 * 2
    assert all(np.isfinite(m["loss"]) for m in hist) and len(hist) == 2
    assert all(st["W"].is_cuda and st["W"].dtype == torch.bfloat16
               for st in state["tiles"].classes.values())


ZOO = ["mixtral-8x7b", "deepseek-v2-236b", "minicpm3-4b", "recurrentgemma-9b",
       "mamba2-2.7b", "seamless-m4t-large-v2"]


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [80, 32])
@pytest.mark.parametrize("arch", ZOO)
def test_lm_zoo_forward_on_the_card_matches_the_cpu(cuda, arch, seq):
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import tree_map
    from repro_torch.models.lm import LM

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch, smoke=True)
    model = LM(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, seq)).astype(np.int32))
    frames = None
    if cfg.frontend:
        frames = torch.from_numpy((0.1 * rng.standard_normal(
            (4, seq, cfg.d_model))).astype(np.float32))
    with torch.no_grad():
        want, aux = model.forward(params, toks, frames)
        got, aux_card = model.forward(
            tree_map(lambda t: t.cuda(), params), toks.cuda(),
            None if frames is None else frames.cuda())
    err = (got.cpu() - want).abs().max().item()
    assert err <= 2e-6 * want.abs().max().item(), err
    np.testing.assert_allclose(aux_card.item(), aux.item(), rtol=2e-6)


@pytest.mark.cuda
def test_model_gathers_are_reproducible_on_the_card(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import common, moe

    gen = torch.Generator(device="cuda")
    ids = torch.randint(0, 64, (8, 4096), device="cuda", generator=gen)
    gate = torch.randint(0, 8, (256, 2), device="cuda", generator=gen)
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True),
                              moe_impl="ragged")

    def grads(fn, *shapes):
        gen.manual_seed(1)
        ins = [torch.randn(s, device="cuda", generator=gen).requires_grad_(True)
               for s in shapes]
        out = fn(*ins)
        return torch.autograd.grad(out, ins, torch.ones_like(out))

    def ragged(x, wi, wg, wo):
        p = {"router": torch.zeros(64, 8, device="cuda"), "wi": wi, "wg": wg,
             "wo": wo}
        xt = x.reshape(1, 256, 64)
        _, gv, _, _ = moe.route(p, xt, cfg)
        # 512 (token, slot) pairs on 8 experts: each row of wi read 64 times
        return moe._ragged_moe(p, xt, gv, gate.reshape(1, 256, 2), cfg)

    cases = {
        "take_rows": (lambda w: common.take_rows(w, ids), [(64, 256)]),
        "select_experts": (lambda w: moe._select_experts(w, gate),
                           [(8, 64, 32)]),
        "ragged": (ragged, [(256, 64), (8, 64, 32), (8, 64, 32), (8, 32, 64)]),
        "ssd_head_repeat": (lambda x: x.reshape(8, 512, 1, 1, 128).expand(
            8, 512, 1, 80, 128).reshape(8, 512, 80, 128), [(8, 512, 1, 128)]),
    }
    for name, (fn, shapes) in cases.items():
        first = grads(fn, *shapes)
        for _ in range(4):
            again = grads(fn, *shapes)
            assert all(torch.equal(a, b) for a, b in zip(first, again)), name
