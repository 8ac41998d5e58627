"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU:
reduced smollm-135m through a two-device fleet, dense and paged, with the
launcher's own audit (every request in ``hv.log`` against a ``vs-`` slice);
and without ``--device cpu`` it raises where CUDA is absent, as every entry
point of the port does."""
import pytest
import torch

from repro_torch.launch import serve

torch.set_num_threads(1)

ARGS = ["--arch", "smollm-135m", "--reduce", "--device", "cpu",
        "--requests", "12", "--devices", "2"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launcher_serves_every_request_through_a_vslice(capsys, paged):
    out = serve.main(ARGS + (["--paged"] if paged else []))
    text = capsys.readouterr().out
    assert out["requests"] == out["serve_events"] == 12
    assert out["tokens"] == 12 * 12                 # --max-new 12
    assert out["slices"] == ["vs-00001", "vs-00002", "vs-00003"]
    assert out["tokens_per_s"] > 0 and out["median_latency_ms"] > 0
    assert "audit: all 12 requests logged against hypervisor vSlices" \
        in text
    assert ("dev-0-0 pages:" in text) == paged
    for t in ("tenant-0", "tenant-1", "tenant-2"):
        assert f"{t}: 4 served on vs-" in text


def test_launcher_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(args)
