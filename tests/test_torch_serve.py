"""The port's serving entry point, end to end on the CPU at the smoke
config: every mode runs, returns well-formed tokens and its numbers."""
import pytest
import torch

from repro_torch.launch import serve

COMMON = ["--smoke", "--device", "cpu", "--adapters", "3", "--batch", "4",
          "--prompt-len", "6", "--tokens", "3"]


@pytest.mark.parametrize("mode", [[], ["--fuse"],
                                  ["--multi-tenant", "--skew", "1.0"],
                                  ["--multi-tenant", "--int8", "--skew",
                                   "1.0"]])
def test_serve_modes(mode):
    stats = serve.main(COMMON + mode)
    out = stats["last_out"]
    assert out.shape == (4, 3) and out.dtype == torch.int32
    assert 0 <= int(out.min()) and int(out.max()) < 256
    if "--multi-tenant" in mode:
        # every request on adapter_0: the scheduler fuses it, close()
        # un-fuses it again
        assert stats["fuse_transitions"] == 1 and stats["table_bytes"] > 0
    else:
        assert len(stats["switch_ms"]) == (1 if mode else 3)


def test_serve_rejects_int8_without_multi_tenant():
    with pytest.raises(SystemExit):
        serve.main(COMMON + ["--int8"])
