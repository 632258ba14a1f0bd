"""Captured frames: one CUDA graph per capacity class.

Counterpart of `jello_tpu/tpu/render.py::_get_compiled` (`:95-128`) and
`_get_present` (`:192-245`). jello_tpu traces a frame into one XLA
executable per capacity class and the present into a second one per
output geometry; here a `FrameProgram` captures one frame of a class
(the frame function the renderer hands it: `render_frame` and
`pack_flags`) into a `torch.cuda.CUDAGraph` with a memory pool of its
own, and every later frame of the class is one replay. Its `present`
captures the frame's assembly and present the same way, once for each
output geometry and (premul, srgb), reading the frame's outputs where
they lie.

A program is keyed as jello_tpu keys an executable (`caps_key`: the
padded scene length, the stop table's and atlas's shapes, the caps with
the frame's routing) and the fine stage: the layout (stream offsets and
counts, target size and tile grid width, base color) is not part of the
key but an input, packed into one int32 device tensor
(`pipeline/render.py::pack_layout`, as `tpu/render.py:294`), which the
frame unpacks into 0-dim views; the kernels read the width in tiles from
it on the device, as the Pallas kernels take it by scalar prefetch. So
every scene of a class runs the one program: a path added or removed, a
cubic flattened into lines, a target resized inside the tile grid.

A program owns static tensors. Its inputs (scene words, packed layout,
stop table, atlas) are copies, into which `run` copies a frame's inputs
on the stream, device to device (a tensor is skipped when it is the one
the last run copied). Its outputs (the fine output and the packed flags, the
u8 surface of a present) are overwritten by every run: a caller that
keeps one past the next run copies it. On the CPU there is no graph:
`run` calls the function and copies its results into the same static
outputs, so that outputs alias from frame to frame as they do on the
card.

A capture cannot read the device, so a program holds only a frame whose
shapes and loop bounds depend on the class alone: the reference fine
stage (`pipeline/fine_ref.py`) walks to two bounds of the class when a
frame rerouted there replays (`cuda/render.py`). The sharded frames
(`cuda/sharded.py`, `cuda/sharded2.py`) are programs too, with their
collectives inside the graph; the caller says whether to capture (NCCL
collectives on the card) or to run the function into the static outputs
(gloo, which copies through the host, and the CPU). A capture that fails
raises; nothing falls back to the eager frame. `Programs` keeps a
caller's programs by key and logs each build.

A frame's stage clock (`profiler.stage_clock`) is captured with it: its
nine stamps are kernel nodes of the graph, so every replay stamps its own
stages. The whole frame is captured on the one side stream `capture`
opens (no stage launches on a stream of its own), so each stamp follows
the work of the stage before it. `graph_ops` reads a graph's nodes back.
"""

from __future__ import annotations

import time

import torch


def caps_key(inputs, caps) -> tuple:
    """jello_tpu's caps_key (`tpu/render.py:390-394`): the padded scene
    length, the stop table's shape, the atlas's shape or None, and the
    sorted caps with the frame's routing. Nothing of the layout: a
    program reads it from the device."""
    scene, _, ramps, atlas = inputs
    return (scene.shape[0], tuple(ramps.shape), None if atlas is None else tuple(atlas.shape),
            tuple(sorted(caps.items())))


def program_key(inputs, caps, fine_name) -> tuple:
    """The key of a frame's program: `caps_key` and the fine stage's name.
    Every scene of a class shares its program, whatever its path count,
    stream offsets or target size inside the class's tile grid."""
    return caps_key(inputs, caps) + (fine_name,)


def key_summary(key) -> str:
    """One line that names a program key's class: tile grid, mode, fine
    stage and input shapes."""
    n, ramps, atlas, caps, fine_name = key[:5]
    caps = dict(caps)
    return (f"tile grid {caps.get('tile_grid_cap')} {caps.get('aa_mode', 'area')} "
            f"{fine_name}{' (kernel H)' if caps.get('_interp_batch') else ''}, scene {n} words, "
            f"stop table {ramps[0]}x{ramps[1]}, atlas {'none' if atlas is None else atlas}, "
            f"pair_cap {caps.get('pair_cap')}"
            + (f", clip depth {caps['clip_depth_cap']}" if "clip_depth_cap" in caps else "")
            + (f", walk {caps['ref_slots_cap']} slots x {caps['ref_chunks_cap']} chunks"
               if "ref_slots_cap" in caps else ""))


def map_tensors(out, fn):
    """fn applied to every tensor of a nest of tuples, lists, dicts and
    tensors (other leaves kept)."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(map_tensors(o, fn) for o in out)
    if isinstance(out, dict):
        return {k: map_tensors(v, fn) for k, v in out.items()}
    return out


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"program output changed from {dst.dtype} {tuple(dst.shape)} to "
                             f"{src.dtype} {tuple(src.shape)}")
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif isinstance(dst, dict):
        for k, d in dst.items():
            _copy_into(d, src[k])


def capture(fn, args):
    """fn(*args) captured into a CUDA graph with a memory pool of its own,
    on a side stream: (graph, fn's outputs, which each replay
    overwrites). Raises if fn raises or the capture fails (a
    host-device synchronization inside fn, a host tensor copied in). The
    captured graph is kept beside its executable (`raw_cuda_graph()`), so
    that what a replay runs can be read from its nodes."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.instantiate()
    return graph, out


def graph_ops(graph) -> dict:
    """{device operation: nodes} of a captured CUDA graph (the
    `torch.cuda.CUDAGraph` that `cuda/program.py::capture` keeps), read
    from the graph itself through the CUDA driver API: a kernel node under
    its function's demangled name (as torch.profiler names it), memcpy and
    memset nodes together under "copies and memsets"; nodes that run
    nothing (event records and waits, empty joins) are left out."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cxx = ctypes.CDLL("libstdc++.so.6")
    cxx.__cxa_demangle.restype = ctypes.c_void_p
    cxx.__cxa_demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)]
    libc = ctypes.CDLL("libc.so.6")
    libc.free.argtypes = [ctypes.c_void_p]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA driver error {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t()
    check(cuda.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {}
    for node in nodes:
        kind = ctypes.c_int()
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS_v2, func first
            check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
                  "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            check(cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])),
                  "cuFuncGetName")
            status = ctypes.c_int()
            p = cxx.__cxa_demangle(name.value, None, None, ctypes.byref(status))
            key = name.value.decode()
            if status.value == 0 and p:
                key = ctypes.string_at(p).decode()
                libc.free(p)
        elif kind.value in (1, 2):  # CU_GRAPH_NODE_TYPE_MEMCPY, _MEMSET
            key = "copies and memsets"
        else:
            continue
        out[key] = out.get(key, 0) + 1
    return out


class Captured:
    """fn(*args) on fixed argument tensors. On the card, captured once
    (`capture`; with `warm`, after one eager call that loads kernels no
    frame has launched yet) and replayed by `run`; on the CPU, called by
    `run`, its results copied into the outputs of the first call. `run`
    returns the outputs, which the next run overwrites."""

    def __init__(self, fn, args, cuda, warm=False):
        self._fn, self._args = fn, args
        self._graph = None
        self.out = None
        if cuda:
            if warm:
                fn(*args)
            self._graph, self.out = capture(fn, args)

    def run(self):
        if self._graph is not None:
            self._graph.replay()
        elif self.out is None:
            self.out = self._fn(*self._args)
        else:
            _copy_into(self.out, self._fn(*self._args))
        return self.out


class FrameProgram:
    """The frame of one class on static inputs (module docstring).

    inputs: (scene words, packed layout int32 [18] (`pipeline.render.
    pack_layout`), stop table, atlas or None) of the frame that builds the
    program, copied; frame_fn(scene, packed layout, ramps, atlas) -> a
    tuple of outputs, the fine output first (the renderer's: fine output,
    packed flags, (flag keys, stat keys)). capture: whether to capture a
    CUDA graph (default: the inputs lie on the card) or to run frame_fn
    into the static outputs. The layout is an input like the others, so
    frames of any layout of the class run the one program."""

    def __init__(self, inputs, frame_fn, capture=None):
        self._last = tuple(inputs)
        self._static = map_tensors(self._last, torch.clone)
        cuda = self._static[0].is_cuda if capture is None else capture
        self._frame = Captured(frame_fn, self._static, cuda)
        self._presents = {}
        self.replays = 0

    @property
    def graph(self):
        """The frame's `torch.cuda.CUDAGraph`, None when its function runs."""
        return self._frame._graph

    @property
    def fine_out(self):
        """The static fine output, None before the first run on the CPU."""
        return None if self._frame.out is None else self._frame.out[0]

    def run(self, inputs):
        """One frame of `inputs` (of the program's key): frame_fn's
        outputs, the static ones. Each input is copied in on the stream,
        ahead of the replay, so a frame in flight reads its own layout."""
        for i, t in enumerate(inputs):
            if t is not self._last[i]:
                if t.shape != self._static[i].shape:
                    raise ValueError(f"program input {i}: {tuple(t.shape)} where the program "
                                     f"holds {tuple(self._static[i].shape)}")
                self._static[i].copy_(t)
        self._last = tuple(inputs)
        out = self._frame.run()
        self.replays += 1
        return out

    def present(self, key, present_fn):
        """present_fn(fine output, packed layout) of the last run: the
        static u8 surface of the present program for `key` (the output
        geometry and the present's switches, as `_get_present` keys its
        executables, `tpu/render.py:196-200`; built on first use, reading
        this program's static fine output and layout)."""
        prog = self._presents.get(key)
        if prog is None:
            prog = self._presents[key] = Captured(present_fn, (self.fine_out, self._static[1]),
                                                  self._static[0].is_cuda, warm=True)
        return prog.run()


class Programs:
    """A caller's programs by key, each built the first time its key runs;
    `compile_log` holds (index, seconds to build it, summary) for each
    build (`tpu/render.py:66-70, 411-416`)."""

    def __init__(self):
        self.by_key: dict = {}
        self.compile_log: list = []

    def get(self, key, build, summary):
        """The program of `key`, built by build() on first use."""
        prog = self.by_key.get(key)
        if prog is None:
            t = time.perf_counter()
            prog = self.by_key[key] = build()
            self.compile_log.append((len(self.compile_log), time.perf_counter() - t, summary))
        return prog
