"""The port's data pipeline against the JAX package's, on the CPU.

* ``BigramLM`` batches are byte-equal to the reference's for the same
  (seed, step, batch, seq_len).
* The reference's ``tests/test_data.py`` replayed on the port.
* ``Prefetcher(device=...)`` places each batch as tensors on the device,
  in step order from ``start_step``, copies of the producer's arrays; a
  producer's exception reaches the consumer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import BigramLM as JBigramLM  # noqa: E402
from repro_torch.data import BigramLM, ImageDataset, Prefetcher  # noqa: E402


@pytest.mark.parametrize("vocab,seed,step,batch,seq", [
    (64, 5, 3, 4, 16), (32, 1, 7, 8, 16), (1000, 0, 0, 2, 33),
    (151, 9, 123456, 5, 1)])
def test_bigram_batches_byte_equal_to_reference(vocab, seed, step, batch, seq):
    got = BigramLM(vocab=vocab, seed=seed).batch(step, batch, seq)
    want = JBigramLM(vocab=vocab, seed=seed).batch(step, batch, seq)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_bigram_deterministic_and_learnable():
    d1 = BigramLM(vocab=64, seed=5)
    d2 = BigramLM(vocab=64, seed=5)
    a = d1.batch(3, 4, 16)
    b = d2.batch(3, 4, 16)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    succ = {}
    big = d1.batch(0, 64, 256)
    for t, lab in zip(big["tokens"].ravel(), big["labels"].ravel()):
        succ.setdefault(int(t), set()).add(int(lab))
    assert max(len(v) for v in succ.values()) <= 8


def test_bigram_host_sharding_consistency():
    d = BigramLM(vocab=32, seed=1)
    full = d.batch(7, 8, 16)["tokens"]
    again = d.batch(7, 8, 16)["tokens"]
    np.testing.assert_array_equal(full, again)


def test_image_dataset():
    ds = ImageDataset(n_train=256, n_test=64, seed=2)
    batches = list(ds.epoch(0, 32))
    assert len(batches) == 8
    assert batches[0]["x"].shape == (32, 28, 28, 1)
    x = ds.x_train.reshape(len(ds.x_train), -1)
    y = ds.y_train
    centroids = np.stack([x[y == c].mean(0) for c in range(10)])
    pred = np.argmin(((ds.x_test.reshape(len(ds.x_test), -1)[:, None]
                       - centroids[None]) ** 2).sum(-1), axis=1)
    assert (pred == ds.y_test).mean() > 0.5


def test_prefetcher():
    seen = []

    def producer(step):
        return {"x": np.full((2, 2), step)}

    pf = Prefetcher(producer, depth=2)
    it = iter(pf)
    for _ in range(4):
        seen.append(int(next(it)["x"][0, 0]))
    pf.close()
    assert seen == [0, 1, 2, 3]
    assert not pf._thread.is_alive()


def test_prefetcher_places_copies_on_the_cpu_from_start_step():
    made = {}

    def producer(step):
        made[step] = {"x": np.full((3, 2), step, np.float32),
                      "y": np.arange(3, dtype=np.int32) + step}
        return made[step]

    pf = Prefetcher(producer, start_step=5, depth=3, device="cpu")
    for step in range(5, 9):
        b = next(pf)
        assert b["x"].device.type == "cpu" and b["x"].dtype == torch.float32
        assert b["y"].dtype == torch.int32
        np.testing.assert_array_equal(b["x"].numpy(), made[step]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), made[step]["y"])
        # a copy: the producer's array can change under it
        made[step]["x"][...] = -1
        assert float(b["x"][0, 0]) == step
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_hands_a_producer_error_to_the_consumer():
    def producer(step):
        if step == 2:
            raise RuntimeError("bad shard")
        return {"x": np.zeros(1)}

    pf = Prefetcher(producer, device="cpu")
    next(pf)
    next(pf)
    with pytest.raises(RuntimeError, match="bad shard"):
        next(pf)
    pf.close()
