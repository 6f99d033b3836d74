"""Captured programs: the port's counterpart of `jax.jit` in serving and
training.

The JAX package serves every call through one compiled program per shape
bucket: `_build_detect` and the fused letterbox+detect cache
(face_vijnana_yolov3_tpu/api/face_detection.py:396, :680), the embed
buckets and the one-program ROI identify chunk
(face_vijnana_yolov3_tpu/api/face_identification.py:185, :411). Here a
program is a CUDA graph of the eager function that already exists:

- the first call of a key copies its inputs into static tensors,
  allocated outside the graph's memory pool, runs the function once on a
  side stream (lazy handles, cuBLAS/cuDNN workspaces), then captures it
  under `torch.inference_mode()` with the flags serving already sets
  (TF32 off, `cudnn.benchmark` off);
- every call copies its inputs into those static tensors, replays the
  graph and clones the outputs out before anything else can replay.

All programs of one cache (one pipeline) share one memory pool. That is
only safe because no output stays in the pool across a replay: a later
capture may place its intermediates where an earlier program's outputs
lie, so the outputs are cloned out right after each replay, on the same
stream, and the static inputs live outside the pool. The programs of a
cache also share their static inputs, one buffer per (position, shape,
dtype): a call copies its inputs in just before its replay, and no
program writes its inputs, so the ROI programs of one staging shape hold
one copy of the staged chunk between them. What a program holds on its own is its
graph and its static outputs; the cache keeps the MAX_PROGRAMS most
recently used and drops the rest (with the input buffers only they used).
Every input must have the shape and dtype it had when its key was first
seen, on the CPU too; otherwise the call raises `ProgramError`. A key
also names what the program bakes in besides its shapes: the detector's
keys carry its precision and a variant (the int8 blocks flag, the bf16
guard depth, or ("int8-front", depth) for the int8 guard, whose program
is the int8 walk with a bf16 tail), so no two kinds of work share a key
when a pipeline's configuration changes.

CUDA graphs and not `torch.compile`: a compiler would re-fuse and reorder
the f32 and bf16 elementwise passes, whose rounding the parity tests pin
(`-fmad=false` kernels, the stock bf16 conv rounding before the bias add).
A replay runs exactly the kernels the eager call launched.

A graph bakes in every address it read at capture, the weights and the
int8 qparams included: A's and A0's TMA descriptors are kernel parameters
(csrc/block_int8.cu, csrc/conv_int8.cu). Whoever replaces weights,
qparams or the folded parameters calls `invalidate()` (the JAX package's
`_invalidate_jits`); a stale graph would read freed memory.

The kernel wrappers count launches where they launch; a replay launches
without calling them, so each program records the counts its capture
added to the registered wrappers (kernels.LAUNCH_COUNTERS) and adds them
again on every replay. chip_smoke.py holds these counts against the
kernels a profiler trace of the replays shows.

Training programs (`ProgramCache(device, train=True)`) are the JAX
package's jitted training steps (face_vijnana_yolov3_tpu/train/trainer.py
`jit_step` / `jit_epoch`, models/qat.py `step`): forward, backward and
optimizer update in one graph, captured with autograd on (also inside a
caller's inference mode). Their carry, the params, BN statistics and
optimizer state, is donated as JAX's `donate_argnums=(0, 1, 2)` donates
it: `run(..., donate=n)` makes the first n inputs the carry, the graph
writes the n first outputs of `fn` back into those static inputs, and the
call returns the static inputs themselves (the other outputs are cloned
out as always). Passed back to the next call, the carry is not copied;
the caller keeps only the newest carry, since the next replay overwrites
it. A donated input has a static input of its own per key, never shared
with another program. One warm-up call precedes each capture, as for
serving: a training step is a pure function of its inputs, so its first
call makes every lazy initialisation (autograd's device threads, cuDNN's
plans and workspaces, cuBLAS's handle); the three warm-ups of PyTorch's
whole-network example are for `torch.optim`'s lazily created state, which
this step does not have. A replay runs the kernels the warm-up ran, so it
equals the eager step bit for bit where those kernels are deterministic
(train/trainer.deterministic).

A program may hold NCCL collectives (the mesh training steps, the DP
serving functions, whose keys carry `parallel.mesh.mesh_key`): NCCL
records them into the graph like any kernel. Their communicator must
exist before the capture, which the warm-up call guarantees, and every
rank must capture and replay the same keys in the same order.

On the CPU (the tests) a program is the eager function itself: the keys,
the buckets, the padding, the input checks and the carry's layout are the
same, nothing is captured. On CUDA a capture or replay error raises
`ProgramError` naming the key; nothing falls back to eager serving or
training.
"""

from __future__ import annotations

import collections
import contextlib
import weakref

import torch

from face_vijnana_yolov3_tpu_torch import kernels

MAX_PROGRAMS = 64  # programs a cache keeps, the most recently used


def watch_weights(model: torch.nn.Module, pipeline) -> None:
    """Call `pipeline._weights_changed()` (drop its folded parameters and
    programs) after every `model.load_state_dict`, holding the pipeline
    weakly: the model must not keep it, or its graphs, alive."""
    ref = weakref.ref(pipeline)

    def hook(_module, _keys):
        p = ref()
        if p is not None:
            p._weights_changed()

    model.register_load_state_dict_post_hook(hook)


class ProgramError(RuntimeError):
    """A program failed to capture or to replay on the card, or was called
    with inputs its key does not fix."""


def _signature(inputs) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in inputs)


def _write_back(carry, new) -> None:
    """Copy the new carry over the old: one `_foreach_copy_` per dtype (a
    list of mixed dtypes would take the one-kernel-a-tensor path)."""
    groups: dict = collections.defaultdict(lambda: ([], []))
    for dst, src in zip(carry, new, strict=True):
        groups[dst.dtype][0].append(dst)
        groups[dst.dtype][1].append(src)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)


class _Graph:
    """One captured program: static inputs, the graph, its static outputs
    (those after the donated carry) and the kernel launches one replay
    makes."""

    def __init__(self, key, graph, static_in, static_out, single, launches, donate):
        self.key = key
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.single = single
        self.launches = launches
        self.donate = donate

    def __call__(self, *inputs):
        try:
            for s, x in zip(self.static_in, inputs, strict=True):
                if x is not s:  # a carry handed back is in place already
                    s.copy_(x)
            self.graph.replay()
            out = (*self.static_in[:self.donate], *(o.clone() for o in self.static_out))
        except RuntimeError as e:
            raise ProgramError(f"replaying the program {self.key!r} failed: {e}") from e
        for k, n in self.launches.items():
            k.launches += n
        return out[0] if self.single else out


class ProgramCache:
    """The captured programs of one pipeline (serving) or of one training
    call (`train=True`), keyed on shapes."""

    def __init__(self, device: torch.device | str, *, train: bool = False):
        self.device = torch.device(device)
        self.train = train
        # key → (input signature, the _Graph; None on the CPU), LRU order
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._static: dict = {}  # (position, shape, dtype) → static input
        self._pool = None
        self._stream = None

    def __len__(self) -> int:
        return len(self._programs)

    def keys(self) -> list:
        """The keys of the programs kept, least recently used first."""
        return list(self._programs)

    def invalidate(self) -> None:
        """Drop every program (and the memory pool and inputs with them)."""
        self._programs.clear()
        self._static.clear()
        self._pool = None

    def _mode(self):
        """Serving programs run under inference mode, training programs
        with autograd on."""
        if not self.train:
            return torch.inference_mode()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode(False))
        stack.enter_context(torch.enable_grad())
        return stack

    def run(self, key, fn, *inputs, donate: int = 0):
        """`fn(*inputs)` (tensors in, a tensor or a tuple of tensors out)
        through the program of `key`, which must fix every input's shape
        and dtype; the first call of a key builds the program. donate: the
        first `donate` inputs are the carry (module docstring), for which
        `fn` returns new values first."""
        sig = _signature(inputs)
        entry = self._programs.get(key)
        if entry is not None and entry[0] != sig:
            raise ProgramError(f"the program {key!r} takes {entry[0]}, got {sig}")
        if entry is None:
            prog = (None if self.device.type != "cuda"
                    else self._capture(key, fn, inputs, donate))
            self._programs[key] = entry = (sig, prog)
            self._evict()
        self._programs.move_to_end(key)
        with self._mode():
            return fn(*inputs) if entry[1] is None else entry[1](*inputs)

    def _evict(self) -> None:
        if len(self._programs) <= MAX_PROGRAMS:
            return
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        used = {id(s) for _sig, g in self._programs.values() if g is not None
                for s in g.static_in}
        self._static = {k: s for k, s in self._static.items() if id(s) in used}

    def _static_inputs(self, key, inputs, donate) -> tuple:
        out = []
        for i, x in enumerate(inputs):
            slot = (key, i) if i < donate else (i, tuple(x.shape), x.dtype)
            if slot not in self._static:
                self._static[slot] = torch.empty_like(x, memory_format=torch.contiguous_format)
            out.append(self._static[slot])
        return tuple(out)

    def _capture(self, key, fn, inputs, donate) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        if any(x.device.type != "cuda" for x in inputs):
            raise ProgramError(f"the program {key!r} takes tensors on the card, got "
                               f"{[str(x.device) for x in inputs]}")
        static_in = self._static_inputs(key, inputs, donate)
        for s, x in zip(static_in, inputs):
            s.copy_(x)
        counters = kernels.LAUNCH_COUNTERS
        graph = torch.cuda.CUDAGraph()
        prev_stream = torch.cuda.current_stream(self.device)
        gen = torch.cuda.default_generators[self.device.index if self.device.index
                                            is not None else torch.cuda.current_device()]
        rng = gen.clone_state()
        try:
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with self._mode():
                with torch.cuda.stream(stream):
                    fn(*static_in)  # warm-up: real launches, counted as such
                warm = {k: k.launches for k in counters}
                try:
                    # thread_local: the prefetch thread may upload the next
                    # chunk (pinned memory, its own stream) meanwhile.
                    with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        out = fn(*static_in)
                        _write_back(static_in[:donate], out[:donate])
                finally:  # the capture recorded these launches; none ran
                    launches = {k: k.launches - warm.get(k, 0) for k in counters
                                if k.launches > warm.get(k, 0)}
                    for k in counters:
                        k.launches = warm.get(k, 0)
        except RuntimeError as e:
            # When capture_end raises, torch.cuda.graph leaves the thread on
            # the capture stream and the card's default generator marked as
            # capturing, so that every later random draw raises: undo both.
            torch.cuda.set_stream(prev_stream)
            gen.graphsafe_set_state(rng)
            self._pool = None  # a failed capture leaves nothing to share
            raise ProgramError(f"capturing the program {key!r} failed: {e}") from e
        torch.cuda.current_stream(self.device).wait_stream(stream)
        single = isinstance(out, torch.Tensor)
        return _Graph(key, graph, static_in, (out,) if single else tuple(out)[donate:],
                      single, launches, donate)
