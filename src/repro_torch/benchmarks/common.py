"""Shared harness for the paper-reproduction benchmarks.

Port of the JAX package's ``benchmarks/common.py``: the paper's own
workloads (the fully analog FCN and LeNet-5 on the procedural MNIST
stand-in) under any of the seven analog training algorithms, with
AIHWKit-style device presets, reporting loss curves, test accuracy and
cumulative pulse counts. Runs on ``device="cuda"`` unless the caller asks
for the CPU.

Also the set-up of the port's FCN runs on the card (``chip_smoke.py``,
``repro_torch.benchmarks.step_profile``): E-RIDER with ``ALGO_HP["erider"]``
on ``device_pair()`` devices, sgdm(0.5) on the digital biases, constant LR
0.2, batch 64 (seed 11).
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..core.device import PRESETS, DeviceConfig
from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
from ..core.plan import AnalogPlan, TilePolicy
from ..core.tile import TileConfig
from ..core.trainer import AnalogTrainer, TrainerConfig, merge_effective
from ..data import ImageDataset
from ..models import convnets


def device_pair(
    *, dw_min: float = 0.01, ref_mean: float = 0.0, ref_std: float = 0.0,
    sigma_pm: float = 0.3, sigma_d2d: float = 0.1, sigma_c2c: float = 0.1,
):
    """(device_p, device_w): nonzero-SP reference on the gradient array P
    (the paper's Tables 1-2 setting), clean-ish main array."""
    dev_p = DeviceConfig(dw_min=dw_min, sigma_pm=sigma_pm, sigma_d2d=sigma_d2d,
                         sigma_c2c=sigma_c2c, ref_mean=ref_mean, ref_std=ref_std)
    dev_w = DeviceConfig(dw_min=dw_min, sigma_pm=sigma_pm, sigma_d2d=sigma_d2d,
                         sigma_c2c=sigma_c2c)
    return dev_p, dev_w


# per-algorithm tuned hyper-parameters (paper App. F.3 analogues).
# grad_norm='absmean' => lr_p counts average pulses/element/step on the fast
# array (AIHWKit auto-granularity semantics); lr_w acts in analog units.
_BASE = dict(grad_norm="absmean", buffered_transfer=True)
ALGO_HP: Dict[str, Dict] = {
    "sgd":      dict(_BASE, lr_w=5.0),
    "ttv1":     dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1),
    "ttv2":     dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1, threshold=1.0),
    "agad":     dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1, eta=0.05, chopper_p=0.1),
    "residual": dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1),
    "rider":    dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1, eta=0.05),
    "erider":   dict(_BASE, lr_p=5.0, lr_w=0.2, gamma=0.1, eta=0.05, chopper_p=0.1),
}

# the FCN runs of the card phases: device_pair()'s devices, E-RIDER's HP
FCN_DEVICE = dataclasses.asdict(device_pair()[1])
ERIDER_HP = ALGO_HP["erider"]


@dataclasses.dataclass
class RunResult:
    algorithm: str
    losses: List[float]
    test_acc: float
    pulses: float
    sp_err: Optional[float]
    steps_to_target: int
    wall_s: float


def cuda_numerics() -> None:
    """Float32 products and convolutions on the card as the reference
    computes them (no TF32; PyTorch allows TF32 in cuDNN by default), and
    deterministic cuDNN algorithms, so that a run on the card repeats bit
    for bit. Process-wide: the convolutions' backward reads these flags
    when it runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def image_trainer(algorithm: str, model_kind: str, dev_p: DeviceConfig,
                  dev_w: DeviceConfig, *, lr: float = 0.2,
                  hp_overrides: Optional[Dict] = None,
                  plan: Optional[AnalogPlan] = None):
    """(trainer, ConvNetConfig, TileConfig) of ``train_image_model``."""
    ccfg = convnets.ConvNetConfig(kind=model_kind)
    hp = dict(ALGO_HP.get(algorithm, {}))
    hp.update(hp_overrides or {})
    tile = TileConfig(algorithm=algorithm, device_p=dev_p, device_w=dev_w, **hp)
    tcfg = TrainerConfig(
        tile=tile,
        digital=DigitalOptConfig(kind="sgdm", momentum=0.5),
        schedule=ScheduleConfig(kind="constant", base_lr=lr),
    )
    if plan is None:
        plan = AnalogPlan.of((convnets.analog_filter,
                              TilePolicy(tile, name=algorithm)),
                             analog_min_ndim=0)
    return AnalogTrainer(convnets.make_loss_fn(ccfg), tcfg, plan=plan), ccfg, tile


def train_image_model(
    *,
    algorithm: str = "erider",
    model_kind: str = "fcn",
    dev_p: DeviceConfig,
    dev_w: DeviceConfig,
    epochs: int = 3,
    batch: int = 64,
    lr: float = 0.2,
    seed: int = 0,
    data: Optional[ImageDataset] = None,
    target_loss: float = 0.0,
    hp_overrides: Optional[Dict] = None,
    sp_estimates=None,
    plan: Optional[AnalogPlan] = None,
    device="cuda",
) -> RunResult:
    """``plan``: optional AnalogPlan for mixed-policy runs; when omitted a
    one-policy plan is built from (algorithm, dev_p, dev_w) gated by the
    convnet's analog filter — the paper's single-device setting.
    ``sp_estimates``: {path: tensor on ``device``}. ``wall_s`` is host time
    from the first step to the test accuracy, the card synchronized."""
    device = torch.device(device)
    if device.type == "cuda":
        cuda_numerics()
    data = data or ImageDataset(n_train=4096, n_test=1024, seed=11)
    trainer, ccfg, tile = image_trainer(algorithm, model_kind, dev_p, dev_w,
                                        lr=lr, hp_overrides=hp_overrides,
                                        plan=plan)
    params = convnets.init_convnet(prng.PRNGKey(seed), ccfg, device)
    state = trainer.init(prng.PRNGKey(seed + 1), params, sp_estimates)
    step_fn = trainer.jit_step()

    losses: List[float] = []
    pulses = 0.0
    sp_err = None
    steps_to_target = -1
    step = 0
    t0 = time.time()
    for ep in range(epochs):
        for b in data.epoch(ep, batch):
            batch_t = {"x": torch.as_tensor(b["x"], device=device),
                       "y": torch.as_tensor(b["y"], device=device)}
            state, m = step_fn(state, batch_t)
            step += 1
            loss = float(m["loss"])
            losses.append(loss)
            pulses += float(m.get("tile/pulses", 0.0))
            if "tile/sp_err" in m:
                sp_err = float(m["tile/sp_err"])
            if steps_to_target < 0 and target_loss > 0:
                recent = np.mean(losses[-20:])
                if len(losses) >= 20 and recent <= target_loss:
                    steps_to_target = step

    # test accuracy with the trained effective weights
    eff = merge_effective(state["params"], state["tiles"], tile)  # bank policies win
    accs = []
    with torch.no_grad():
        for b in data.test_batches(256):
            logits = convnets.convnet_logits(
                eff, torch.as_tensor(b["x"], device=device), ccfg)
            accs.append(np.mean(np.argmax(logits.cpu().numpy(), -1) == b["y"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return RunResult(
        algorithm=algorithm,
        losses=losses,
        test_acc=float(np.mean(accs)),
        pulses=pulses,
        sp_err=sp_err,
        steps_to_target=steps_to_target,
        wall_s=time.time() - t0,
    )


def csv_row(name: str, wall_s: float, derived: str) -> str:
    """`name,us_per_call,derived` convention of benchmarks/run.py."""
    return f"{name},{wall_s * 1e6:.0f},{derived}"


def fcn_trainer(backend: str, preset: str = "") -> AnalogTrainer:
    """The FCN's E-RIDER trainer under ``update_backend=backend``, on
    ``device_pair()``'s devices or on the named ``PRESETS`` entry."""
    dev_p, dev_w = (PRESETS[preset],) * 2 if preset else device_pair()
    return image_trainer("erider", "fcn", dev_p, dev_w,
                         hp_overrides={"update_backend": backend})[0]


def fcn_run(backend: str, device, steps: int, seed: int = 0):
    """(trainer, initial state, ``steps`` batches on ``device``)."""
    trainer = fcn_trainer(backend)
    params = convnets.init_convnet(prng.PRNGKey(seed), convnets.ConvNetConfig(),
                                   device)
    state = trainer.init(prng.PRNGKey(seed + 1), params)
    data = ImageDataset(n_train=steps * 64, n_test=64, seed=11)
    batches = [{"x": torch.as_tensor(b["x"], device=device),
                "y": torch.as_tensor(b["y"], device=device)}
               for b in data.epoch(0, 64)]
    return trainer, state, batches[:steps]
