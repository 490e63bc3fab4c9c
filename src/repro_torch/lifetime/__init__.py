"""Post-training lifetime of analog weights (port of ``repro.lifetime``).

  drift  ``program_weights`` (write-and-verify programming error at t0) and
         ``apply_lifetime`` (conductance drift ``W(t) = W(t0) *
         (t/t0)^-nu`` with per-element nu, plus read noise), from the
         per-preset lifetime coefficients of ``DeviceConfig`` and the
         stateless hash RNG;
  gdc    Global Drift Compensation: a columnwise current-sum signature of
         each weight matrix under a fixed reference input; the ratio of the
         t0 signature (stored in the checkpoint manifest) to the aged one
         is the per-matrix scale GDC applies.
"""
from .drift import (age_params, apply_lifetime, lifetime_cfg_map,  # noqa: F401
                    path_key, program_weights)
from .gdc import (GDC_CHUNKS, correct_params, drift_scale,  # noqa: F401
                  signature_tree, weight_signature)
