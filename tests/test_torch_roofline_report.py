"""The port's dry-run report (``repro_torch.benchmarks.roofline_report``) on
JSONs written by ``launch.dryrun.run_cell``, against the JAX package's
``benchmarks/roofline_report.py`` on the same files: one cell of each
status (``ok``: a traced decode cell and a traced long-context cell, one
row over the data axes; ``skipped``; ``error``: a cell whose accounting
raised), every status with its row, and the reference's table rows and
CSV rows, row for row."""
import pytest

from repro_torch.benchmarks import roofline_report as report
from repro_torch.launch import dryrun

CELLS = [("qwen2-0.5b", "decode_32k", "ok"),
         ("mamba2-2.7b", "long_500k", "ok"),
         ("qwen3-14b", "long_500k", "skipped"),
         ("gemma3-4b", "decode_32k", "error")]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("results") / "dryrun")
    real = dryrun.account_serve

    def broken(*a, **k):
        raise RuntimeError("accounting failed")

    for arch, shape, status in CELLS:
        dryrun.account_serve = broken if status == "error" else real
        try:
            r = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out)
        finally:
            dryrun.account_serve = real
        assert r["status"] == status, r
    return out


def _reference():
    return pytest.importorskip("benchmarks.roofline_report")


def test_every_status_has_a_row(out_dir):
    cells = report.load_cells(out_dir)
    assert sorted(c["status"] for c in cells) == sorted(s for *_, s in CELLS)
    lines = report.fmt_table(cells).splitlines()[2:]
    by_arch = {ln.split("|")[1].strip(): ln for ln in lines}
    assert "| ok |" in by_arch["qwen2-0.5b"]
    assert "| ok |" in by_arch["mamba2-2.7b"]
    long = [c for c in cells if c["shape"] == "long_500k"
            and c["status"] == "ok"][0]
    assert f"| {long['memory']['peak_per_device_gb']:.2f} |" \
        in by_arch["mamba2-2.7b"]
    assert "| skipped (" in by_arch["qwen3-14b"]
    assert "| ERROR |" in by_arch["gemma3-4b"]
    assert report.fmt_table(cells, "pod2x16x16").count("\n") == 1


def test_table_rows_follow_the_reference(out_dir):
    ref = _reference()
    cells = report.load_cells(out_dir)
    theirs = ref.fmt_table(cells).splitlines()
    ours = report.fmt_table(cells).splitlines()
    assert ours == theirs


def test_csv_rows_follow_the_reference(out_dir, monkeypatch):
    ref = _reference()
    rows = report.run(out_dir=out_dir)
    assert rows[0] == "roofline_cells,0,ok=2;skipped=1;errors=1"
    monkeypatch.setattr(ref, "load_cells",
                        lambda *a, **k: report.load_cells(out_dir))
    theirs = ref.run()
    assert theirs[0] == "roofline_cells,0,ok=2;skipped=1;errors=1"
    assert rows[1:] == theirs[1:]
    long = [r for r in rows if r.startswith("roofline_mamba2-2.7b")]
    assert len(long) == 1 and long[0].startswith(
        "roofline_mamba2-2.7b_long_500k_pod16x16,0,bottleneck=")
    ok = [r for r in rows if r.startswith("roofline_qwen2-0.5b")][0]
    name, us, derived = ok.split(",")
    assert name == "roofline_qwen2-0.5b_decode_32k_pod16x16" and us == "0"
    assert derived.startswith("bottleneck=")
