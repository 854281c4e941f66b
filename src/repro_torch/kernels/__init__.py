"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the one contract their wrappers launch through.

``build`` compiles ``csrc/*.cu`` at first use and sets every C entry's
signature from the source.  `launcher` makes a kernel's CUDA body into its
wrapper: the plain version on a CPU tensor, the body on a CUDA tensor
under the device's guard, a refusal on any other device; every launch is
checked for a CUDA error and counted by the wrapper's name
(`launch_counts`).  `device_int` reads a per-device limit from a library
once.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
import inspect
import pkgutil
import threading

import torch

from repro_torch.kernels import build

_COUNT_LOCK = threading.Lock()
# (device index, stream) -> counters that every kernel taking them leaves 0
_counters: dict = {}
_launches: dict = {}     # wrapper name -> launches, under _COUNT_LOCK
_device_ints: dict = {}  # (source, entry, device index) -> what it read


def check_args(anchor: str, want: dict) -> None:
    """Raise ``ValueError`` unless every tensor of ``want`` (name ->
    (tensor, dtype, shape)) lies on the device of ``want[anchor]``, has its
    dtype and shape, and is contiguous: what a kernel's wrapper checks
    before it hands raw pointers to the kernel."""
    dev = want[anchor][0].device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {anchor} on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def zeroed_counters(device: torch.device, stream: int, n: int
                    ) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device`` for a kernel's launch on
    ``stream``, all zero: a kernel that counts its CTAs or warps in them
    sets each back to 0 before it ends (``topic_sum``'s groups, the carry
    fold's rows).  One tensor a stream, shared by those kernels: launches
    on one stream run one after another."""
    key = (device.index, stream)
    got = _counters.get(key)
    if got is None or got.numel() < n:
        got = _counters[key] = torch.zeros(max(n, 1), dtype=torch.int32,
                                           device=device)
    return got


def raise_on_error(source: str, err: int, what: str) -> None:
    """Raise ``RuntimeError`` when ``err``, a return of a C entry of
    ``csrc/<source>.cu``, is not 0, in the words of the library's own
    ``<source>_error_string``."""
    if err:
        lib = build.load(source)
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def device_int(source: str, entry: str, device: torch.device) -> int:
    """What ``int entry(int* out)`` of ``csrc/<source>.cu`` writes to
    ``out`` on ``device`` (a shared-memory opt-in, a topic limit): called
    once per (source, entry, device) with that device current, its result
    kept.  An entry that configures its kernel for the device does so on
    that first call."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (source, entry, index)
    got = _device_ints.get(key)
    if got is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            raise_on_error(source, getattr(build.load(source), entry)(
                ctypes.addressof(out)), f"{entry} on cuda:{index}")
        got = _device_ints[key] = out.value
    return got


class Kernel:
    """A wrapper's hold on its library, made once when `launcher` wraps
    it: ``lib``, the loaded ``csrc/<source>.cu`` (at the first launch),
    and `launch`."""

    __slots__ = ("name", "source", "lib")

    def __init__(self, name: str, source: str):
        self.name, self.source, self.lib = name, source, None

    def launch(self, entry, *c_args) -> None:
        """Call ``entry``, a function of ``lib``, with ``c_args``; raise on
        a CUDA error, else count one launch of the wrapper."""
        err = entry(*c_args)
        if err:
            raise_on_error(self.source, err, f"{self.name} kernel launch")
        with _COUNT_LOCK:
            _launches[self.name] += 1


def launcher(source: str, anchor: str, plain):
    """Make ``body(kernel, stream, *args, **kwargs)`` the wrapper of a
    kernel of ``csrc/<source>.cu``, with the body's name and its arguments
    after the first two.

    The argument ``anchor`` (a tensor, or a device) decides where the call
    runs: on the CPU the wrapper returns ``plain(*args, **kwargs)``; on any
    device but CUDA it raises ``ValueError``; on CUDA it runs the body with
    that device current, ``kernel`` (a `Kernel`, its library loaded) and
    the device's current stream.  The body checks its arguments, makes
    its outputs and launches through ``kernel.launch``, which raises
    ``RuntimeError`` on a CUDA error and counts the launch under the
    wrapper's name in `launch_counts`."""
    def wrap(body):
        kernel = Kernel(body.__name__, source)
        with _COUNT_LOCK:
            _launches[kernel.name] = 0
        sig = inspect.signature(body)
        params = list(sig.parameters.values())[2:]
        at = [p.name for p in params].index(anchor)

        @functools.wraps(body)
        def wrapper(*args, **kwargs):
            x = args[at] if at < len(args) else kwargs[anchor]
            dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
            if dev.type == "cpu":
                return plain(*args, **kwargs)
            if dev.type != "cuda":
                of = "tensors" if isinstance(x, torch.Tensor) else "devices"
                raise ValueError(f"{kernel.name} runs on CPU or CUDA {of}, "
                                 f"not {dev}")
            if kernel.lib is None:
                kernel.lib = build.load(source)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                return body(kernel, stream, *args, **kwargs)

        wrapper.__signature__ = sig.replace(parameters=params)
        return wrapper
    return wrap


@functools.cache
def _import_wrappers() -> None:
    """Import every module of the kernel subpackages: each wrapper joins
    the launch count when its module is imported."""
    for mod in pkgutil.walk_packages(__path__, f"{__name__}."):
        importlib.import_module(mod.name)


def launch_counts(reset: bool = False) -> dict:
    """Each kernel wrapper's launches, by its name; every count set to 0
    first when ``reset``."""
    _import_wrappers()
    with _COUNT_LOCK:
        if reset:
            _launches.update(dict.fromkeys(_launches, 0))
        return dict(sorted(_launches.items()))
