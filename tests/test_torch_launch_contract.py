"""The launch contract of the port's CUDA kernels (``repro_torch.kernels``):
each C entry's ctypes signature is read from its ``.cu`` source
(``build.entries``), every wrapper goes through one prologue
(``kernels.launcher``), and every wrapper is counted by name
(``kernels.launch_counts``).  Reads the sources as text, so it runs
without ``nvcc`` or a card.  The file imports neither ``jax`` nor
``repro``."""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.bp_update.ops import bp_update
from repro_torch.kernels.gibbs_sweep.ops import gibbs_noise, philox_gumbel

KERNELS = Path(kernels.__file__).parent
SOURCES = sorted(p.stem for p in build.CSRC.glob("*.cu"))
WRAPPERS = {"bp_update", "gibbs_noise", "gibbs_sweep", "pack_rows",
            "power_sweep_carry", "power_sweep_carry_train",
            "power_sweep_tokens", "power_topics", "scatter_add_rows",
            "topic_sum", "word_rows_sum"}


def _calls(source: str):
    """The entries of ``source`` that the kernel modules call, by how:
    launched (``kernel.launch``), read per device (``device_int``) or
    called directly."""
    got = {"launch": set(), "device_int": set(), "direct": set()}
    for path in KERNELS.rglob("*.py"):
        text = path.read_text()
        if f'_SOURCE = "{source}"' not in text:
            continue
        got["launch"] |= set(re.findall(
            r"kernel\.launch\(\s*kernel\.lib\.(\w+)", text))
        got["device_int"] |= set(re.findall(
            r'device_int\(_SOURCE,\s*"(\w+)"', text))
        got["direct"] |= set(re.findall(r"\blib\.(\w+)\(", text))
    return got


def test_every_source_has_a_wrapper_module():
    assert len(SOURCES) == 7
    assert all(any(_calls(s).values()) for s in SOURCES)


@pytest.mark.parametrize("source", SOURCES)
def test_each_called_entry_is_in_its_sources_extern_c_block(source):
    entries = build.entries(source)
    calls = _calls(source)
    called = set().union(*calls.values())
    assert called and called <= set(entries), called - set(entries)
    ptr = ctypes.c_void_p
    for name in calls["launch"]:
        # a launch returns a CUDA error code and takes the stream last
        restype, argtypes = entries[name]
        assert restype is ctypes.c_int and argtypes[-1] is ptr, name
    for name in calls["device_int"]:
        assert entries[name] == (ctypes.c_int, [ptr]), name
    assert entries[f"{source}_error_string"] == (ctypes.c_char_p,
                                                 [ctypes.c_int])
    # every parameter and return maps to a ctypes type the table names
    allowed = {ptr, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong,
               ctypes.c_float}
    for name, (restype, argtypes) in entries.items():
        assert restype in (ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p)
        assert set(argtypes) <= allowed, name


def test_the_parser_reads_what_the_prototypes_say(tmp_path, monkeypatch):
    (tmp_path / "demo.cu").write_text("""
__global__ void k(int* p) { if (p) { *p = 0; } }
extern "C" {
// a comment { with braces }
int demo_launch(const float* x, unsigned seed, long long t0, int n,
                float a, void* stream) {
  if (n > 0) { k<<<1, 1, 0, (cudaStream_t)stream>>>(nullptr); }
  return 0;
}
/* int not_an_entry(double); */
long long demo_words(int T, int Pk) { return (long long)T * Pk; }
int demo_declared(int* out);
const char * demo_error_string(int err) { return "e"; }
}  // extern "C"
""")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    c = ctypes
    assert build.entries("demo") == {
        "demo_launch": (c.c_int, [c.c_void_p, c.c_uint, c.c_longlong,
                                  c.c_int, c.c_float, c.c_void_p]),
        "demo_words": (c.c_longlong, [c.c_int, c.c_int]),
        "demo_declared": (c.c_int, [c.c_void_p]),
        "demo_error_string": (c.c_char_p, [c.c_int])}


@pytest.mark.parametrize("proto, entry, spelled", [
    ("int bad_arg(double x, void* stream)", "bad_arg", "double"),
    ("void bad_ret(int n)", "bad_ret", "void"),
    ("int bad_size(size_t n)", "bad_size", "size_t")])
def test_an_unmapped_c_type_is_refused_naming_source_and_entry(
        tmp_path, monkeypatch, proto, entry, spelled):
    (tmp_path / "demo.cu").write_text(
        f'extern "C" {{\n{proto} {{ return; }}\n}}\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(ValueError, match=rf"demo\.cu: {entry} .*'{spelled}'"):
        build.entries("demo")


def test_launch_counts_hold_every_wrapper_by_name():
    counts = launch_counts()
    assert set(counts) == WRAPPERS
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())


@pytest.mark.parametrize("call, of", [
    (lambda x: bp_update(x[:, 0].int(), x[:, 0].int(), x[:, :1], x, x, x,
                         x[0], alpha=0.1, beta=0.01, wbeta=1.0), "tensors"),
    (lambda x: gibbs_noise(1, 0, 2, 3, x.device), "devices")])
def test_the_prologue_refuses_a_device_that_is_not_cpu_or_cuda(call, of):
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match=f"runs on CPU or CUDA {of}, not meta"):
        call(x)


def test_a_wrapper_on_the_cpu_runs_its_plain_version_and_counts_nothing():
    before = launch_counts()
    got = gibbs_noise(5, 1, 3, 4, "cpu", t0=2)
    assert torch.equal(got, philox_gumbel(5, 1, 3, 4, "cpu", t0=2))
    assert launch_counts() == before


def test_no_kernel_module_imports_the_core():
    for path in KERNELS.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.startswith("repro_torch.core") for n in names), \
                path
