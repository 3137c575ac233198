"""The A/B timing tool of the port's flash-attention builds, on the CPU: its
argument parsing and its refusal to run without a CUDA device."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import pytest

from daft_tpu_torch.tools import ab_attention


@pytest.mark.parametrize("arg,expected", [
    ("base=daft_tpu_torch/csrc",
     ("base", Path("daft_tpu_torch/csrc/flash_attention.cu"), [])),
    ("ser=_ab/v6:-DDEV_PIPELINE=0", ("ser", Path("_ab/v6/flash_attention.cu"), ["-DDEV_PIPELINE=0"])),
    ("x=d:-DA=1 -DB", ("x", Path("d/flash_attention.cu"), ["-DA=1", "-DB"])),
])
def test_parse_build(arg, expected):
    assert ab_attention.parse_build(arg) == expected


@pytest.mark.parametrize("arg", ["daft_tpu_torch/csrc", "=dir", "name=", ""])
def test_parse_build_rejects(arg):
    with pytest.raises(argparse.ArgumentTypeError):
        ab_attention.parse_build(arg)


def test_exits_without_cuda_device():
    code = ("import sys, torch; assert not torch.cuda.is_available(); "
            "from daft_tpu_torch.tools import ab_attention as m; "
            "sys.exit(m.main(['base=daft_tpu_torch/csrc']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent.parent,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert "no CUDA device" in out.stderr
