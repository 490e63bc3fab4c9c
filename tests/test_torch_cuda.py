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
* Serving (the smoke configs of every decoder-only arch): chunk prefill
  and paged decode on the card within 2e-6 of the CPU's largest magnitude
  (qwen2, gemma3; and minicpm3, recurrentgemma, mamba2 for their per-lane
  latent and state rows, SSD state within 1e-5); a free lane past its
  table row (MLA: past its latent row) runs without a device assert and
  keeps its rows; the continuous engine equals the fixed driver on the
  card, and both equal the CPU, token for token; the encoder-decoder's
  fixed driver on the card gives the CPU's tokens.
* The paper's LeNet-5: K1 bit-equal on its tiles as the wrapper meets them
  (the HWIO conv kernels viewed as (25, 16) and (400, 32), their fused
  stacks, fc1); its first 3 E-RIDER steps on the card against the CPU
  under both backends (loss within rtol 1e-5, tile elements off only
  where a pulse of P flipped, <= 0.1 %) and bit-equal from run to run
  with deterministic cuDNN; a max-pool window of ties routes its gradient
  as on the CPU.
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


# ---------------------------------------------------------------------------
# serving (the page-pool attention families)
# ---------------------------------------------------------------------------

SERVE_ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma3-4b", "qwen2-vl-2b",
               "mixtral-8x7b", "minicpm3-4b", "deepseek-v2-236b",
               "recurrentgemma-9b", "mamba2-2.7b"]


def _serve_model(arch):
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.paths import tree_map
    from repro_torch.models.lm import LM

    model = LM(get_config(arch, smoke=True))
    cpu = model.init(prng.PRNGKey(0), device="cpu")
    return model, cpu, tree_map(lambda t: t.cuda(), cpu)


def _paged_run(model, params, device, steps=3, drift=False):
    """A 2-row bucketed prefill into the pools, then ``steps`` per-lane
    decode steps (lane 1 freed and past its row when ``drift``): the
    logits of every call and the final pools, on the CPU."""
    from repro_torch.core.paths import flatten_with_path

    cfg = model.cfg
    S = 24 if cfg.window else 10
    T = -(-(S + 8) // 4)
    tables = torch.stack([torch.arange(1, T + 1), torch.arange(T + 1, 2 * T + 1)]
                         ).to(torch.int32)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    lens = torch.tensor([S, S - 3], dtype=torch.int32)
    paged = model.init_paged_cache(2, 2 * T + 1, 4, S + 8, device=device)
    d = torch.device(device)
    logits, _ = model.prefill_commit_batch(
        params, toks.to(d), paged, tables.to(d), torch.arange(2).to(d),
        torch.zeros(2, dtype=torch.int32, device=d), lens.to(d),
        torch.ones(2, dtype=torch.bool, device=d))
    out = [logits.cpu()]
    pos = lens.clone()
    live = torch.ones(2, dtype=torch.bool)
    for i in range(steps):
        if drift and i == steps - 1:
            tables[1] = 0
            pos[1] = 3 * T * 4 + 1
            live[1] = False
        tok = torch.argmax(out[-1][:, -1], -1).to(torch.int32)[:, None]
        logits, _ = model.decode_step_lanes(params, tok.to(d), paged,
                                            tables.to(d), pos.to(d), live.to(d))
        out.append(logits.cpu())
        pos = pos + 1
    return out, {p: t.cpu() for p, t in flatten_with_path(paged)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-4b"])
def test_paged_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """Chunk prefill and paged decode (gemma3: a prompt past its 16-token
    window) on the card against the CPU from the same parameters: logits
    and the pools within 2e-6 of their largest magnitude (cuBLAS sums in
    another order; TF32 off); then a free lane whose position drifted past
    its all-scratch table row runs without a device assert (its page column
    is clamped) and leaves lane 0's logits within the same tolerance (the
    free lane's own logits read the scratch page and are discarded)."""
    model, cpu, card = _serve_model(arch)
    with torch.no_grad():
        want, want_pools = _paged_run(model, cpu, "cpu", drift=True)
        got, got_pools = _paged_run(model, card, "cuda", drift=True)
    torch.cuda.synchronize()
    # the free lane's own output is discarded, and the scratch page (page 0)
    # keeps an arbitrary one of its repeated writers: neither is compared
    got[-1], want[-1] = got[-1][:1], want[-1][:1]
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= 2e-6 * w.abs().max().item(), (i, err)
    for p, w in want_pools.items():
        g, w = got_pools[p][..., 1:, :, :, :], w[..., 1:, :, :, :]
        err = (g - w).abs().max().item()
        assert err <= 2e-6 * max(w.abs().max().item(), 1e-30), (p, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_lane_rows_on_the_card_match_the_cpu(cuda, arch):
    """The per-lane leaves (MLA latent and position rows, RG-LRU / SSD
    state) through a chunk prefill and three paged decode steps, the last
    with lane 1 free and past its rows: logits within 2e-6 of the CPU's
    largest magnitude (lane 0's at the free step), float leaves within
    2e-6 (SSD state 1e-5), positions equal; lane 1's rows held."""
    model, cpu, card = _serve_model(arch)
    with torch.no_grad():
        want, want_leaves = _paged_run(model, cpu, "cpu", drift=True)
        got, got_leaves = _paged_run(model, card, "cuda", drift=True)
    torch.cuda.synchronize()
    got[-1], want[-1] = got[-1][:1], want[-1][:1]
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= 2e-6 * w.abs().max().item(), (i, err)
    rows = [p for p in want_leaves if "/kp" not in p and "/vp" not in p]
    assert rows
    for p in rows:
        g, w = got_leaves[p], want_leaves[p]
        if not w.is_floating_point():
            assert torch.equal(g, w), p
            continue
        rel = 1e-5 if "/state/" in p and "/conv/" not in p else 2e-6
        err = (g - w).abs().max().item()
        assert err <= rel * max(w.abs().max().item(), 1e-30), (p, err)


@pytest.mark.cuda
def test_encdec_fixed_driver_on_the_card_matches_the_cpu(cuda):
    """seamless-m4t-large-v2 smoke through ``run_fixed`` (the encoder over
    ``FeedBuilder``'s frames, the cross K/V cached): the same tokens on the
    card and on the CPU, and no kernel of K1/K2/K3."""
    from repro_torch.launch.serve import build_workload, run_fixed

    model, cpu, card = _serve_model("seamless-m4t-large-v2")
    launches = dict(ops.LAUNCHES)
    wl = build_workload(model.cfg, 4, 12, 6)
    got = run_fixed(model, card, [r.clone() for r in wl], batch=2)
    want = run_fixed(model, cpu, [r.clone() for r in wl], batch=2)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert dict(ops.LAUNCHES) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_continuous_matches_fixed_on_the_card(cuda, arch):
    """The reference tests' workload (5 requests, prompt 10, gen 4+-2, 2
    lanes, page 4, a shared 8-token prefix, chunk 8): on the card the
    continuous engine gives the fixed driver's tokens, and both give the
    CPU's; no kernel of K1/K2/K3 launches."""
    from repro_torch.launch.serve import build_workload, run_fixed
    from repro_torch.serving import EngineConfig, ServeEngine

    model, cpu, card = _serve_model(arch)
    launches = dict(ops.LAUNCHES)

    def serve(params):
        wl = build_workload(model.cfg, 5, 10, 4, gen_spread=2, prefix_len=8)
        fixed = run_fixed(model, params, [r.clone() for r in wl], batch=5)
        tw = -(-(10 + max(r.max_new_tokens for r in wl)) // 4)
        cont, _ = ServeEngine(model, params, EngineConfig(
            lanes=2, page_size=4, num_pages=2 * tw + 5, max_len=tw * 4,
            prefill_chunk=8, prefix_share=True)).run(wl)
        return fixed, cont

    fixed, cont = serve(card)
    fixed_cpu, cont_cpu = serve(cpu)
    for rid in fixed:
        np.testing.assert_array_equal(cont[rid], fixed[rid], err_msg=rid)
        np.testing.assert_array_equal(fixed[rid], fixed_cpu[rid], err_msg=rid)
        np.testing.assert_array_equal(cont[rid], cont_cpu[rid], err_msg=rid)
    assert dict(ops.LAUNCHES) == launches


# ---------------------------------------------------------------------------
# the paper's workloads: LeNet-5
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(25, 16), (400, 32), (5, 5, 1, 16),
                                   (1, 5, 5, 16, 32), (1568, 512)])
def test_analog_update_kernel_on_lenet_tiles(cuda, shape):
    """LeNet-5's tiles as the wrapper meets them: the HWIO conv kernels
    (viewed as (25, 16) and (400, 32)), their fused (1, ...) class stacks
    and fc1; float32, threefry noise; bit-equal to the plain version."""
    from repro_torch import prng

    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=10)
    rng = np.random.default_rng(7)
    w, dw, gamma, rho = _card(
        [rng.uniform(-0.8, 0.8, shape).astype(np.float32),
         (0.05 * rng.standard_normal(shape)).astype(np.float32),
         np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32),
         (0.3 * rng.standard_normal(shape)).astype(np.float32)],
        ["float32"] * 4)
    noise = ops.make_noise(prng.PRNGKey(8), shape, "cuda")
    before = ops.LAUNCHES["analog_update"]
    got = ops.analog_update(w, dw, gamma, rho, None, noise=noise, **kw)
    assert ops.LAUNCHES["analog_update"] == before + 1
    want = ref.analog_update_ref(w, dw, gamma, rho, *noise, **kw)
    torch.cuda.synchronize()
    assert got.shape == w.shape and torch.equal(got, want)


def _lenet_steps(backend, device, steps=3):
    """LeNet-5 under ``train_image_model``'s E-RIDER trainer on
    ``device_pair()``'s devices, its state drawn on the CPU and carried to
    ``device``: (loss per step, float tile leaves, biases, K1 launches,
    tiles)."""
    from repro_torch import prng
    from repro_torch.benchmarks.common import device_pair, image_trainer
    from repro_torch.core.paths import tree_map_with_path
    from repro_torch.core.trainer import HOST_LEAVES
    from repro_torch.data import ImageDataset
    from repro_torch.models import convnets

    trainer, ccfg, _ = image_trainer("erider", "lenet5", *device_pair(),
                                     hp_overrides={"update_backend": backend})
    state = trainer.init(prng.PRNGKey(1),
                         convnets.init_convnet(prng.PRNGKey(0), ccfg, "cpu"))
    n_tiles = sum(len(ps) for _, ps in state["tiles"].index)
    state = tree_map_with_path(
        lambda p, t: t if p.rsplit("/", 1)[-1] in HOST_LEAVES else t.to(device),
        state)
    before = ops.LAUNCHES["analog_update"]
    losses = []
    for b in ImageDataset(n_train=64 * steps, n_test=64, seed=11).epoch(0, 64):
        state, m = trainer.train_step(
            state, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
    tiles = {f"{c}/{k}": st[k].cpu() for c, st in state["tiles"].classes.items()
             for k in ("W", "P", "Qd", "Qt", "H") if st.get(k) is not None}
    biases = {k: state["params"][k]["b"].cpu() for k in state["params"]}
    return losses, tiles, biases, ops.LAUNCHES["analog_update"] - before, n_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["vmap", "fused"])
def test_lenet5_first_steps_on_the_card_match_the_cpu(cuda, backend):
    """3 steps from one CPU-drawn state (``chip_smoke.py`` phase 14a's
    standard): loss within rtol 1e-5; every float tile leaf within 1e-5 but
    for <= 0.1 % of its elements, each where a pulse of P flipped (P off
    there by >= a tenth of dw_min 0.01); biases within rtol 1e-5; 2 K1
    launches per tile per step; a second card run bit-equal."""
    from repro_torch.benchmarks.common import cuda_numerics

    cuda_numerics()
    card = _lenet_steps(backend, "cuda")
    again = _lenet_steps(backend, "cuda")
    cpu = _lenet_steps(backend, "cpu")
    assert card[0] == again[0]
    for k, v in card[1].items():
        assert torch.equal(v, again[1][k]), k
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for k, want in cpu[1].items():
        diff = (card[1][k] - want).abs()
        off = diff > 1e-5
        assert off.float().mean().item() <= 1e-3, k
        p = k.rsplit("/", 1)[0] + "/P"
        assert bool(((card[1][p] - cpu[1][p]).abs()[off] >= 1e-3).all()), k
    for k, want in cpu[2].items():
        np.testing.assert_allclose(card[2][k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert card[3] == 2 * card[4] * 3 and card[4] == 5


@pytest.mark.cuda
def test_lenet5_maxpool_ties_route_on_the_card_as_on_the_cpu(cuda):
    """A pooled window of exact ties (tanh saturated to 1.0) sends its
    gradient to its first maximum on the card too."""
    from repro_torch.models import convnets

    rng = np.random.default_rng(4)
    x = rng.choice([1.0, 1.0, 0.5], size=(2, 8, 8, 16)).astype(np.float32)
    cot = torch.from_numpy(rng.standard_normal((2, 4, 4, 16)).astype(np.float32))
    grads = []
    for device in ("cpu", "cuda"):
        t = torch.from_numpy(x).to(device).requires_grad_(True)
        torch.sum(convnets._maxpool(t) * cot.to(device)).backward()
        grads.append(t.grad.cpu())
    assert torch.count_nonzero(grads[0]).item() == cot.numel()
    assert torch.equal(grads[0], grads[1])
