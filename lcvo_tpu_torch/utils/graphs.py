"""Compiled steps: the port's counterpart of ``jax.jit`` with ``donate_argnums``.

The JAX package compiles its per-frame step, its keyframe step and its batched steps
once and replays them, the state donated (``lcvo_tpu/pipeline.py:503-504``, ``:520``,
``parallel/streams.py:62-70,104-114``). Eager PyTorch dispatches every op from the host,
3,000-5,000 of them a frame, and the card waits for the host most of the time.
:func:`compile_step` wraps an eager function so that on the card it runs as a CUDA
graph:

- **Capture.** The first call for a key captures ``fn`` into a
  ``torch.cuda.CUDAGraph``; every later call with that key copies its arguments into
  the graph's input buffers (unless they already are those buffers), replays the
  graph and returns its outputs. The key is the argument tree, the shape, dtype and
  device of each tensor in it and its Python scalars (the counterpart of
  ``static_argnames``).
- **Warm-up.** Before a capture ``fn`` runs once, eagerly, on copies of the arguments,
  on the capture stream: lazy device constants, library handles and workspaces are made
  there, outside the capture, and the arguments stay as the caller left them.
- **Randomness** is an argument, as in the JAX package, whose steps take a key: the
  port's steps take the uniforms of that key (``utils/jax_random.py``), an input buffer
  written before each replay like any other, so a replay draws what the eager call
  draws.
- **Donation** (``donate=True``, the counterpart of ``donate_argnums=(0,)``). The first
  argument is the state, and ``fn`` returns its new value first. On the first call the
  state's tensors become the graph's input buffers as they are (adopted, not copied; a
  tensor that shares memory with an earlier one of the state is cloned first), and at
  the end of the captured region the new state is written back into them. The returned
  state *is* those buffers, so the next call passes them back with no copy. Outputs may
  alias inputs (``process_frame`` returns ``prev_R=state.R``; unchanged fields come back
  as they went in). This module resolves that with temporaries, not with a second set
  of buffers: a field that comes back as its own buffer is not written, and every value
  that reads a buffer about to be written (a source of the write-back, or another
  output) is first copied to a temporary inside the graph, so all reads come before all
  writes. ``donate=False``: the input buffers are the graph's own copies and the state
  comes back as a clone, so the caller's old state stays valid.
- **Outputs** that are not the donated state come back as clones made after the
  replay: the next replay overwrites the graph's own.
- **Device rule.** CPU tensors run ``fn`` eagerly; so do CUDA tensors inside
  :func:`disable_graphs` (the counterpart of ``jax.disable_jit()``), which a caller asks
  for to compare with the eager run, and in a step made with ``eager=True`` (one whose
  work the backend cannot capture: a gloo collective). A capture that fails raises
  :class:`GraphCaptureError` naming the operation; nothing falls back to eager.
  ``replayed`` tells whether the last call replayed a graph.
- **Collectives.** A step that holds an NCCL collective is captured with
  ``capture_mode="thread_local"``: under CUDA's default ``global`` mode a CUDA call of
  another thread (ProcessGroupNCCL's watchdog queries its events) breaks the capture.
  The warm-up makes the communicator, outside the capture.
- **Launch accounting.** ``kernels.LAUNCHES`` counts Python calls of a kernel's
  wrapper, and a replay passes no Python. So the wrapper takes back what the counters
  moved during the warm-up (copies whose results are dropped: set-up) and the capture
  (which launches nothing), and adds the capture's amount at every replay. The counters
  read what the eager run reads: launches of the path's own work on the device.
- **Memory.** The graphs of one compiled step share one memory pool, and a caller
  passes ``pool=`` to share one between steps that never run at the same time (the
  graphs of one ``VisualOdometry``). Each graph keeps its outputs alive, so another
  graph of the pool reuses only its temporaries.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.utils import profiling

_SCALARS = (bool, int, float, str, type(None))
_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Run compiled steps eagerly on the card too, for as long as the block lasts (the
    counterpart of ``jax.disable_jit()``). The eager call neither reads nor writes a
    graph's buffers: the caller's arguments go to ``fn`` as they are."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """One tensor, or two views of the same memory with the same layout."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                      and a.shape == b.shape and a.stride() == b.stride())


def _assign(pairs) -> int:
    """``dst <- src`` for each ``(dst, src)`` pair of tensors that are not one tensor. A
    source that shares memory with a destination is copied to a temporary first, so
    every read comes before every write. Returns the number of tensors written."""
    pairs = [(d, s) for d, s in pairs if not _same(d, s)]
    written = {_storage(d) for d, _ in pairs}
    pairs = [(d, s.clone() if _storage(s) in written else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)
    return len(pairs)


def _clones(leaves: list) -> list:
    """The leaves with every tensor cloned."""
    return [x.clone() if torch.is_tensor(x) else x for x in leaves]


def _unaliased(leaves: list) -> list:
    """The leaves with every tensor that shares memory with an earlier one cloned."""
    seen, out = set(), []
    for x in leaves:
        if torch.is_tensor(x):
            if _storage(x) in seen:
                x = x.clone()
            seen.add(_storage(x))
        out.append(x)
    return out


def place(dst, src):
    """The host loop's write of a new value into a tree it owns (a state, a window):
    ``src``'s values are copied into ``dst``'s tensors and ``dst`` is returned, so the
    graphs that read ``dst``'s buffers see them with no recapture. Where ``dst`` is
    None, its tree or a tensor's shape or dtype differs from ``src``'s, or two of its
    tensors share memory (a state that came from an eager step), a copy of ``src`` is
    returned instead: buffers of the caller's own, which share memory with nothing
    (on the CPU a frame's tensor may be the caller's numpy array)."""
    sl, spec = tree_flatten(src)
    if dst is not None:
        dl, dspec = tree_flatten(dst)
        fits = dspec == spec and all(
            (d is None and s is None) or (torch.is_tensor(d) and torch.is_tensor(s)
                                          and d.shape == s.shape and d.dtype == s.dtype
                                          and d.device == s.device)
            for d, s in zip(dl, sl))
        if fits and all(a is b for a, b in zip(_unaliased(dl), dl)):
            _assign([(d, s) for d, s in zip(dl, sl) if d is not None])
            return dst
    return tree_unflatten(_clones(sl), spec)


def _where(exc: BaseException) -> str:
    """The innermost frame of the failure outside this module and outside torch: the
    operation the capture could not take."""
    skip = (os.path.abspath(__file__), os.path.dirname(os.path.abspath(torch.__file__)))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(skip)]
    if not frames:
        return "the end of the capture (no operation of the step raised)"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({(f.line or '').strip()})"


class _CudaGraphs:
    """Warm-up, capture and replay on a CUDA device; the graphs of one step share its
    capture stream and memory pool."""

    def __init__(self, device: torch.device, pool, mode: str = "global"):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.mode = mode

    def warmup(self, run) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            run()
        cur.wait_stream(self.stream)

    def capture(self, body):
        torch.cuda.synchronize(self.device)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            g.capture_begin(pool=self.pool, capture_error_mode=self.mode)
            try:
                outs = body()
            except BaseException:
                # end the broken capture so the stream leaves capture mode; the error
                # raised inside the step is the one to report
                with contextlib.suppress(RuntimeError):
                    g.capture_end()
                raise
            g.capture_end()
        t1 = time.perf_counter()
        nodes = _graph_nodes(g)
        g.instantiate()
        info = {"capture_s": t1 - t0, "instantiate_s": time.perf_counter() - t1,
                "nodes": nodes}
        return (g, outs), info

    def replay(self, handle):
        g, outs = handle
        g.replay()
        return outs

    def nodes(self) -> int:
        """Nodes captured so far (called inside :meth:`capture`'s body)."""
        return _captured_so_far(self.stream.cuda_stream)

    def node_kinds(self, handle) -> list:
        return _node_kinds(handle[0])

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this pool's segments."""
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))


_DRIVER = None
# CUgraphNodeType, by value
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
               "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
               "batch_mem_op", "conditional")


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                                     "blockDimY", "blockDimZ", "sharedMemBytes")] + [
        ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver():
    """The CUDA driver API, its calls that this module makes declared."""
    global _DRIVER
    if _DRIVER is None:
        cu = ctypes.CDLL("libcuda.so.1")
        p, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        sigs = {"cuGraphGetNodes": [p, p, size_p],
                "cuGraphNodeGetType": [p, ctypes.POINTER(ctypes.c_int)],
                "cuGraphKernelNodeGetParams_v2": [p, ctypes.POINTER(_KernelNodeParams)],
                "cuFuncGetName": [ctypes.POINTER(ctypes.c_char_p), p],
                "cuKernelGetName": [ctypes.POINTER(ctypes.c_char_p), p],
                # (stream, status, id, graph, dependencies, [edge data,] count)
                "cuStreamGetCaptureInfo_v3": [p, ctypes.POINTER(ctypes.c_int), p,
                                              ctypes.POINTER(p), p, p, p],
                "cuStreamGetCaptureInfo_v2": [p, ctypes.POINTER(ctypes.c_int), p,
                                              ctypes.POINTER(p), p, p]}
        for name, argtypes in sigs.items():
            if hasattr(cu, name):
                fn = getattr(cu, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _DRIVER = cu
    return _DRIVER


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed ({code})")


def _count_nodes(graph) -> int:
    n = ctypes.c_size_t(0)
    _check(_driver().cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def _graph_nodes(g: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (kernels, copies, memsets): ``cuGraphGetNodes`` of the
    CUDA driver API."""
    return _count_nodes(ctypes.c_void_p(g.raw_cuda_graph()))


def _captured_so_far(stream: int) -> int:
    """Nodes of the graph that ``stream`` is capturing into, so far."""
    cu, status, graph = _driver(), ctypes.c_int(0), ctypes.c_void_p()
    s = ctypes.c_void_p(stream)
    if hasattr(cu, "cuStreamGetCaptureInfo_v3"):
        code = cu.cuStreamGetCaptureInfo_v3(s, ctypes.byref(status), None, ctypes.byref(graph),
                                            None, None, None)
    else:
        code = cu.cuStreamGetCaptureInfo_v2(s, ctypes.byref(status), None, ctypes.byref(graph),
                                            None, None)
    _check(code, "cuStreamGetCaptureInfo")
    return _count_nodes(graph) if graph.value else 0


_KERNEL_NAMES: dict = {}         # function or kernel handle -> demangled name


def _kernel_name(p: _KernelNodeParams):
    """The demangled name of a kernel node's function, as the profiler prints it; looked
    up once per function (a graph launches few distinct kernels many times)."""
    handle = p.func or p.kern
    if handle in _KERNEL_NAMES:
        return _KERNEL_NAMES[handle]
    cu, name, code = _driver(), ctypes.c_char_p(), -1
    if p.func and hasattr(cu, "cuFuncGetName"):
        code = cu.cuFuncGetName(ctypes.byref(name), p.func)
    elif p.kern and hasattr(cu, "cuKernelGetName"):
        code = cu.cuKernelGetName(ctypes.byref(name), p.kern)
    got = torch._C._demangle(name.value.decode()) if code == 0 and name.value else None
    if handle:
        _KERNEL_NAMES[handle] = got
    return got


def _node_kinds(g: torch.cuda.CUDAGraph) -> list:
    """Each node of a captured graph in capture order: ``(type, kernel name)``, the name
    demangled as the profiler prints it, ``None`` where the node is no kernel or the
    driver gives none."""
    cu, graph = _driver(), ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(_count_nodes(graph))
    arr = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, arr, ctypes.byref(n)), "cuGraphGetNodes")
    params = hasattr(cu, "cuGraphKernelNodeGetParams_v2")
    t, p, out = ctypes.c_int(-1), _KernelNodeParams(), []
    for node in arr[:n.value]:
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(t)), "cuGraphNodeGetType")
        kind = _NODE_TYPES[t.value] if 0 <= t.value < len(_NODE_TYPES) else str(t.value)
        name = None
        if kind == "kernel" and params and cu.cuGraphKernelNodeGetParams_v2(
                node, ctypes.byref(p)) == 0:
            name = _kernel_name(p)
        out.append((kind, name))
    return out


class _Entry:
    """One captured graph: its input buffers, how many output leaves are the donated
    state (returned as they are), launches per replay, figures of the capture, and
    counts of its replays and of the tensors they copied in and cloned out."""

    def __init__(self, backend, bufs, handle, n_keep, launches, info):
        self.backend = backend
        self.bufs = bufs
        self.handle = handle
        self.n_keep = n_keep
        self.launches = launches
        self.info = info
        self.replays = 0
        self.copies_in = 0          # tensors copied into the input buffers, all replays
        self.clones = None          # output tensors cloned a replay


class CompiledStep:
    """``fn`` behind CUDA graphs; see the module docstring and :func:`compile_step`."""

    def __init__(self, fn, donate=True, pool=None, name=None, capture=None, eager=False,
                 capture_mode="global"):
        self.fn = fn
        self.donate = bool(donate)
        self.pool = pool
        self.name = name or getattr(fn, "__name__", "step")
        self.eager = bool(eager)
        self.capture_mode = capture_mode
        self.replayed = False       # whether the last call replayed a graph
        self._capture_with = capture
        self._backends: dict = {}
        self._entries: dict = {}
        self._span = "graph." + self.name

    # -- calling -------------------------------------------------------------------
    def __call__(self, *args):
        # one test for the spans that only a trace needs (graph.<name>, copy_in, copy_out)
        if profiling.tracing():
            return profiling.within(self._span, self._call, args, True)
        return self._call(args, False)

    def _call(self, args, traced: bool):
        leaves, spec = tree_flatten(args)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        if _disabled or self.eager or (self._capture_with is None
                                       and not any(t.device.type == "cuda" for t in tensors)):
            self.replayed = False
            return self.fn(*args)
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"{self.name}: tensors on {sorted(map(str, devices))}: a "
                             f"compiled step takes them on one device")
        key = (spec, tuple(self._key_of(x) for x in leaves))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._capture(args, leaves, spec, devices.pop())
        else:
            pairs = [(b, x) for b, x in zip(entry.bufs, leaves) if torch.is_tensor(b)]
            entry.copies_in += (profiling.within("graph.copy_in", _assign, pairs) if traced
                                else _assign(pairs))
        return self._replay(entry, traced)

    def _key_of(self, x):
        if torch.is_tensor(x):
            return (tuple(x.shape), x.dtype, x.device)
        if isinstance(x, _SCALARS):
            return (type(x), x)
        raise TypeError(f"{self.name}: a compiled step takes tensors and Python scalars in "
                        f"its arguments, got a {type(x).__name__}")

    def _backend(self, device):
        if self._capture_with is not None:
            return self._capture_with
        if device not in self._backends:
            self._backends[device] = _CudaGraphs(device, self.pool, self.capture_mode)
            self.pool = self._backends[device].pool
        return self._backends[device]

    def captures(self) -> int:
        """Graphs captured so far (one per key)."""
        return len(self._entries)

    # -- capture -------------------------------------------------------------------
    def _capture(self, args, leaves, spec, device) -> _Entry:
        backend = self._backend(device)
        n_don = len(tree_flatten(args[0])[0]) if self.donate else 0
        # the donated state's tensors are adopted (de-aliased), every other tensor copied
        bufs = _unaliased(leaves[:n_don]) + _clones(leaves[n_don:])
        static = tree_unflatten(bufs, spec)
        counts = dict(kernels.LAUNCHES)

        copies = tree_unflatten(_clones(bufs), spec)
        t0 = time.perf_counter()
        backend.warmup(lambda: self.fn(*copies))
        warmup_s = time.perf_counter() - t0
        del copies
        kernels.LAUNCHES.update(counts)

        don_bufs = bufs[:n_don]
        state_spec = tree_flatten(args[0])[1] if self.donate else None

        def body():
            out = self.fn(*static)
            if not self.donate:
                return out
            new, new_spec = tree_flatten(out[0])
            if new_spec != state_spec:
                raise TypeError(f"{self.name}: the state it returns has another tree than "
                                f"the state it takes, so it cannot be donated")
            pairs = []
            for b, s in zip(don_bufs, new):
                if (b is None) != (s is None) or (b is not None and (
                        b.shape != s.shape or b.dtype != s.dtype)):
                    raise TypeError(f"{self.name}: a state tensor comes back as "
                                    f"{None if s is None else (tuple(s.shape), s.dtype)} "
                                    f"for {None if b is None else (tuple(b.shape), b.dtype)}")
                if b is not None:
                    pairs.append((b, s))
            rest, rest_spec = tree_flatten(tuple(out[1:]))
            # outputs that read a buffer the write-back overwrites are taken first
            written = {_storage(b) for b, s in pairs if not _same(b, s)}
            rest = [x.clone() if torch.is_tensor(x) and _storage(x) in written else x
                    for x in rest]
            _assign(pairs)
            return (static[0], *tree_unflatten(rest, rest_spec))

        try:
            with profiling.capturing(self.name, getattr(backend, "nodes", None)) as cap:
                handle, info = backend.capture(body)
        except Exception as exc:
            kernels.LAUNCHES.update(counts)
            raise GraphCaptureError(f"{self.name}: CUDA graph capture failed at {_where(exc)}: "
                                    f"{type(exc).__name__}: {exc}") from exc
        t0 = time.perf_counter()
        if cap is not None and cap.record(self.name, lambda: backend.node_kinds(handle)):
            info = {**info, "stages_s": time.perf_counter() - t0}
        launches = {k: kernels.LAUNCHES[k] - counts[k] for k in counts}
        kernels.LAUNCHES.update(counts)
        return _Entry(backend, bufs, handle, n_don, launches, {"warmup_s": warmup_s, **info})

    def _replay(self, entry: _Entry, traced: bool):
        out = profiling.within("graph.launch", entry.backend.replay, entry.handle)
        for k, n in entry.launches.items():
            kernels.LAUNCHES[k] += n
        entry.replays += 1
        self.replayed = True
        leaves, spec = tree_flatten(out)
        n = entry.n_keep
        rest = (profiling.within("graph.copy_out", _clones, leaves[n:]) if traced
                else _clones(leaves[n:]))
        if entry.clones is None:
            entry.clones = sum(torch.is_tensor(x) for x in rest)
        return tree_unflatten(leaves[:n] + rest, spec)

    # -- figures -------------------------------------------------------------------
    def stats(self) -> list[dict]:
        """One dict per captured graph: the step's name, warm-up, capture and
        instantiation seconds, graph nodes (on the card), replays, kernel launches per
        replay, the tensors a replay copied into the graph's input buffers (on average) and
        the output tensors it cloned."""
        return [{"name": self.name, **e.info, "replays": e.replays,
                 "launches_per_replay": {k: n for k, n in e.launches.items() if n},
                 "copies_in_per_replay": e.copies_in / max(e.replays, 1),
                 "clones_per_replay": e.clones or 0}
                for e in self._entries.values()]

    def pool_bytes(self) -> int:
        """Bytes held in the memory pool of this step's graphs (0 before a capture on
        the card)."""
        return sum(b.pool_bytes() for b in self._backends.values())


def compile_step(fn, *, donate=True, pool=None, name=None, capture=None, eager=False,
                 capture_mode="global"):
    """``fn`` as a compiled step: CUDA graphs on the card, eager on the CPU (module
    docstring). The randomness ``fn`` draws from is among its tensor arguments.
    ``donate``: write the new state (``fn``'s first result) back into the first
    argument's buffers; ``pool``: a ``torch.cuda.graph_pool_handle()`` to share with
    other compiled steps; ``eager``: never capture (work the backend cannot capture);
    ``capture_mode``: CUDA's ``capture_error_mode``, ``"thread_local"`` for a step with
    an NCCL collective. ``capture`` stands in for the CUDA capture (``warmup(run)``,
    ``capture(body) -> (handle, info)``, ``replay(handle) -> outputs``) in the CPU tests
    of the bookkeeping; nothing in the package sets it of its own."""
    return CompiledStep(fn, donate=donate, pool=pool, name=name, capture=capture, eager=eager,
                        capture_mode=capture_mode)
