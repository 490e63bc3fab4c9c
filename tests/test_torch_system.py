"""The paper's two end-to-end claims on the port's CPU path, at the
reference's exact settings and seeds (``tests/test_system.py``):

1. A fully analog FCN trained with E-RIDER on nonzero-SP devices learns
   (loss drops, accuracy above chance) and tracks the SP.
2. E-RIDER beats TT-v2 under a large SP reference offset on ~4-state
   devices (the Tables 1-2 claim).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks.common import device_pair, train_image_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests train for hundreds of steps of small element-wise ops.
    Under the suite's parallel workers torch's per-process thread pools
    oversubscribe the cores and every op waits on its slowest thread (an
    order of magnitude slower than the module alone), so it runs on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_analog_fcn_learns_and_tracks_sp():
    dev_p, dev_w = device_pair(dw_min=0.02, ref_mean=0.3, ref_std=0.2)
    res = train_image_model(algorithm="erider", dev_p=dev_p, dev_w=dev_w,
                            epochs=1, seed=0, device="cpu")
    assert res.losses[0] > res.losses[-1]
    assert res.test_acc > 0.3, res.test_acc  # 10 classes, chance = 0.1
    assert res.sp_err is not None and res.sp_err < 0.3 ** 2 + 0.2 ** 2


def test_erider_beats_ttv2_under_offset():
    dev_p, dev_w = device_pair(dw_min=0.4622, sigma_pm=0.7125,
                               sigma_c2c=0.2174, ref_mean=0.4, ref_std=0.4)
    r_tt = train_image_model(algorithm="ttv2", dev_p=dev_p, dev_w=dev_w,
                             epochs=2, seed=1, device="cpu")
    r_er = train_image_model(algorithm="erider", dev_p=dev_p, dev_w=dev_w,
                             epochs=2, seed=1, device="cpu")
    assert r_er.test_acc > r_tt.test_acc, (r_er.test_acc, r_tt.test_acc)

