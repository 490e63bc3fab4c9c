"""Fig. 4 (left) — total pulse cost to reach a target loss vs #states.

Port of the JAX package's ``benchmarks/fig4_pulse_cost.py``. Two-stage (ZS
calibration + TT-v2) pays N calibration pulses per element *plus* training
pulses; E-RIDER pays training pulses only. As the number of conductance
states grows (dw_min shrinks), the calibration bill explodes (Thm 2.2)
while E-RIDER's stays flat — the paper's headline efficiency claim.
"""
from __future__ import annotations

import time
from typing import List

from .common import device_pair, train_image_model


def run(quick: bool = True, device="cuda") -> List[str]:
    rows = []
    # number of states = (tau_max + tau_min) / dw_min = 2 / dw_min
    dwmins = [0.1, 0.02] if quick else [0.1, 0.05, 0.02, 0.01, 0.004]
    epochs = 2 if quick else 4
    target = 1.2 if quick else 0.8
    for dw in dwmins:
        states = int(round(2.0 / dw))
        dev_p, dev_w = device_pair(dw_min=dw, ref_mean=0.2, ref_std=0.2)
        n_params = 784 * 256 + 256 * 128 + 128 * 10  # FCN analog elements

        # E-RIDER: training pulses only
        t0 = time.time()
        res_e = train_image_model(algorithm="erider", dev_p=dev_p, dev_w=dev_w,
                                  epochs=epochs, target_loss=target, seed=2,
                                  device=device)
        rows.append(f"fig4_erider_states{states},{(time.time()-t0)*1e6:.0f},"
                    f"train_pulses={res_e.pulses:.3e};steps_to_target={res_e.steps_to_target}")

        # two-stage: ZS pulses (Thm 2.2: N ~ 1/(delta*dw_min) per element)
        # + TT-v2 training pulses
        zs_budget_per_elem = min(8000, int(1.0 / dw * 40))
        zs_total = zs_budget_per_elem * n_params
        t0 = time.time()
        res_t = train_image_model(algorithm="ttv2", dev_p=dev_p, dev_w=dev_w,
                                  epochs=epochs, target_loss=target, seed=2,
                                  device=device)
        rows.append(f"fig4_zs_ttv2_states{states},{(time.time()-t0)*1e6:.0f},"
                    f"total_pulses={zs_total + res_t.pulses:.3e};"
                    f"zs_pulses={zs_total:.3e};train_pulses={res_t.pulses:.3e}")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
