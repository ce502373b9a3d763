"""The port's nvcc build cache key.

A kernel library's file name carries a digest of its source, the shared
headers, the architecture flags and the `nvcc --version` text, so a
library built for another target or by another toolkit is never loaded.
The version is read once per process, only when a build or a load asks
for the name.  Nothing here needs nvcc: the reader is replaced.
"""

import subprocess

import pytest

from wittgenstein_tpu_torch.ops import kernels


@pytest.fixture
def fake_nvcc(monkeypatch):
    calls = []
    text = ["Cuda compilation tools, release 12.8, V12.8.93\n"]

    def run(cmd, **kw):
        calls.append(cmd)
        assert cmd[1:] == ["--version"]
        return subprocess.CompletedProcess(cmd, 0, stdout=text[0], stderr="")

    monkeypatch.setattr(kernels, "nvcc_path", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", run)
    monkeypatch.setattr(kernels, "_NVCC_VERSION", [])
    return calls, text


def test_name_changes_with_version_and_flags(fake_nvcc, monkeypatch):
    calls, text = fake_nvcc
    lib = kernels.CudaLibrary("popcount_words.cu")
    first = lib.lib_path()
    assert first.parent == kernels.BUILD_DIR and first.name.startswith("libpopcount_words_")
    assert lib.lib_path() == first and len(calls) == 1  # read once per process
    monkeypatch.setattr(kernels, "_NVCC_VERSION", [])
    text[0] = "Cuda compilation tools, release 12.9, V12.9.41\n"
    other_toolkit = lib.lib_path()
    assert other_toolkit != first and len(calls) == 2
    monkeypatch.setattr(kernels, "ARCH_FLAGS", ("-gencode", "arch=compute_100a,code=sm_100a"))
    other_target = lib.lib_path()
    assert len({first, other_toolkit, other_target}) == 3
    # each library its own name
    assert kernels.CudaLibrary("lowest_set_bit.cu").lib_path() != other_target


def test_nothing_reads_the_version_at_import(fake_nvcc):
    calls, _ = fake_nvcc
    lib = kernels.CudaLibrary("pack_bool_words.cu")
    assert lib.builds == lib.loads == 0 and calls == []
