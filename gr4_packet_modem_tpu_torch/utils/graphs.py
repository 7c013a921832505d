"""Replay a step's stages from captured CUDA graphs.

A bank step issues several hundred small device operations, and on the
card the host's dispatch of them, not the device, sets the step's pace.
:class:`StepGraphs` captures each stage of a step (a method decorated
with :func:`stage`) as a CUDA graph and replays it, so that it costs the
host one launch. The same kernels run in the same order on the same
stream, so the outputs are bit-identical to the eager step.

A step (:meth:`StepGraphs.step`) opens a *chain*, keyed by the step's
arguments; inside an open chain each stage call goes through
:meth:`StepGraphs.run`:

- the first step with a key runs eagerly (it also warms the host-side
  tables that some stages build on first use);
- the second captures each stage and replays it;
- later steps replay, after checking that each stage gets the arguments it
  was captured with.

A key is made of every tensor argument's address, shape, strides and dtype
and of the other arguments' values (a dataclass argument counts as its
fields), so a stage's graph is replayed only where its inputs sit where it
reads them. Stages called outside a step, on the CPU, while the program's
tracing (``utils/trace.py``) is on, or inside someone else's capture run
eagerly. The chains are kept least recently used first, at most
:data:`CAPACITY`; a chain whose stage meets other arguments than its
capture is dropped and its step finishes eagerly. A step runs with the
bank's device current, so that its graphs are captured and replayed on
the stream its eager kernels use, whichever device is current outside it.

A graph also reads, by address, the device tables that the stages look up
in caches (``ops/crc.py``'s ``_device_tables``, ``ops/acquire_cuda.py``'s
``_tables`` and ``_bf16_device_tables``). No cache on a stage's path may
therefore drop a device tensor: those caches are unbounded, and a new
cache of device tensors there has to be too.

The graph's outputs are static: each replay writes the same tensors. The
caller of a step copies them out (:func:`owned`) before it returns them.

Every step counts one of ``captured``, ``replayed`` or ``eager``, and each
chain dropped counts ``evicted``; the counts are always kept, on the
object (:attr:`StepGraphs.counts`) and in ``trace.totals()["counters"]``
as ``rx.graph.<count>``. ``ops/_build.py``'s launch counts and the
counters a stage adds (``trace.count``, such as ``rx.extract.chunks``)
stay those of the eager step: a capture takes back what it counted and
each replay adds it.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from contextlib import contextmanager

import torch

from ..ops import _build
from . import trace

__all__ = ["StepGraphs", "stage", "arg_key", "owned"]

COUNTS = ("captured", "replayed", "eager", "evicted")
CAPACITY = 16  # chains a StepGraphs keeps


def arg_key(a):
    """A hashable key of an argument: a tensor's address, shape, strides,
    dtype and device; a dataclass's fields; a tuple's, list's or dict's
    items; any other value as it is."""
    if isinstance(a, torch.Tensor):
        return ("T", a.data_ptr(), tuple(a.shape), a.stride(), a.dtype, a.device)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (type(a), *(arg_key(getattr(a, f.name)) for f in dataclasses.fields(a)))
    if isinstance(a, (tuple, list)):
        return (type(a), *(arg_key(v) for v in a))
    if isinstance(a, dict):
        return (dict, *((k, arg_key(v)) for k, v in sorted(a.items())))
    return a


def stage(method):
    """Make ``method`` a stage that a step in flight on the object's
    ``step_graphs`` (a :class:`StepGraphs`, or None) captures and replays;
    outside a step it runs as it is."""
    name = method.__qualname__

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        graphs = self.step_graphs
        if graphs is None or graphs.chain is None:
            return method(self, *args, **kwargs)
        return graphs.run(name, functools.partial(method, self, *args, **kwargs), (args, kwargs))

    return call


@dataclasses.dataclass
class _Stage:
    key: tuple
    graph: object
    out: object
    launches: dict
    counters: dict


@dataclasses.dataclass
class _Chain:
    key: tuple
    stages: list = dataclasses.field(default_factory=list)
    ready: bool = False  # every stage captured
    pos: int = 0  # the next stage of the step in flight
    dropped: bool = False


class StepGraphs:
    """The captured stages of a step, per key, for one object's steps (a
    ``Receiver``'s ``bank_step`` and ``stream_step``), at most :data:`CAPACITY` chains.

    Every graph on a device draws on one memory pool. That is safe because
    a step replays its chain to the end, and its caller copies the results
    out, before another step's graphs run: no two chains' graphs are ever
    in flight at once, and a chain's outputs, which later captures never
    reuse, are read only within its own step. Steps of one object must
    therefore run one after another on one stream."""

    def __init__(self):
        self.chains: OrderedDict[tuple, _Chain] = OrderedDict()
        self.counts = dict.fromkeys(COUNTS, 0)
        self.chain: _Chain | None = None  # the chain of the step in flight
        # device -> (the graphs' memory pool, the capture stream)
        self._capture_on: dict[torch.device, tuple] = {}

    # --------------------------------------------------------------- policy

    def engages(self, x: torch.Tensor) -> bool:
        """Whether a step on ``x`` may run from graphs: on a CUDA device,
        with the program's tracing off (its spans record events and
        annotations at every call) and outside another capture."""
        if not x.is_cuda or trace.enabled():
            return False
        with self._on(x.device):
            return not torch.cuda.is_current_stream_capturing()

    def _on(self, device: torch.device):
        """A context with ``device`` current: a graph is captured on, and
        replays into, the current device's current stream."""
        return torch.cuda.device(device)

    def clear(self) -> None:
        """Drop every chain (the tables the graphs read were replaced)."""
        for _ in range(len(self.chains)):
            self._evict(next(iter(self.chains)))

    def _count(self, name: str) -> None:
        self.counts[name] += 1
        trace.count("rx.graph." + name)

    def _evict(self, key) -> None:
        self.chains.pop(key).dropped = True
        self._count("evicted")

    # ------------------------------------------------------------- the step

    @contextmanager
    def step(self, x: torch.Tensor, *args):
        """Open the chain of a step on ``x`` (with its other arguments
        ``args``) around the step's stages. Yields whether the stages run
        from graphs: then their outputs are static, and the caller copies
        them out (:func:`owned`)."""
        if not self.engages(x):
            self._count("eager")
            yield False
            return
        key = (arg_key(x), arg_key(args))
        chain = self.chains.get(key)
        if chain is None:  # first sight: eager
            self.chains[key] = _Chain(key)
            if len(self.chains) > CAPACITY:
                self._evict(next(iter(self.chains)))
            self._count("eager")
            yield False
            return
        self.chains.move_to_end(key)
        capturing = not chain.ready
        chain.pos = 0
        self.chain = chain
        try:
            with self._on(x.device):
                yield True
        except BaseException:
            if capturing and not chain.dropped:
                self._evict(key)
            raise
        finally:
            self.chain = None
        if chain.dropped:
            self._count("eager")
        elif capturing:
            chain.ready = True
            self._count("captured")
        else:
            self._count("replayed")

    def run(self, name: str, fn, args):
        """Run stage ``name`` (``fn()``, called with ``args``) of the step
        in flight: capture and replay it, or replay its graph."""
        chain = self.chain
        key = (name, arg_key(args))
        if not chain.ready:
            launched, counted = _build.launch_counts(), trace.counters()
            graph, out = self._capture(fn)
            launches = {k: n - launched[k] for k, n in _build.launch_counts().items() if n != launched[k]}
            _build.add_launch_counts({k: -n for k, n in launches.items()})
            counters = {k: n - counted.get(k, 0) for k, n in trace.counters().items() if n != counted.get(k, 0)}
            for k, n in counters.items():
                trace.count(k, -n)
            chain.stages.append(_Stage(key, graph, out, launches, counters))
        i = chain.pos
        chain.pos += 1
        st = chain.stages[i] if i < len(chain.stages) else None
        if st is None or st.key != key:
            # other arguments than at capture: the rest of the step eagerly
            self._evict(chain.key)
            self.chain = None
            return fn()
        self._replay(st.graph)
        _build.add_launch_counts(st.launches)
        for k, n in st.counters.items():
            trace.count(k, n)
        return st.out

    # ------------------------------------------------------ capture, replay

    def _capture(self, fn):
        """Capture ``fn()`` into a CUDA graph on a side stream of the
        current device (the caller's may be the legacy default stream,
        which cannot capture) after returning the cached blocks the eager
        steps left (so that the pool does not come on top of them). Returns
        ``(graph, outputs)``; the graph has not run."""
        torch.cuda.empty_cache()
        caller = torch.cuda.current_stream()
        if caller.device not in self._capture_on:
            self._capture_on[caller.device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(caller.device))
        pool, side = self._capture_on[caller.device]
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated by the failure above
                raise
            graph.capture_end()
        caller.wait_stream(side)
        return graph, out

    def _replay(self, graph) -> None:
        """Launch ``graph`` on the current stream."""
        graph.replay()


def _collect(a, seen: dict[int, torch.Tensor]) -> None:
    """Each non-empty tensor in ``a`` (tensors, in tuples and dataclasses)
    into ``seen``, by identity."""
    if isinstance(a, torch.Tensor):
        if a.numel():
            seen.setdefault(id(a), a)
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            _collect(getattr(a, f.name), seen)
    elif isinstance(a, (tuple, list)):
        for v in a:
            _collect(v, seen)


def _rebuild(a, copies: dict[int, torch.Tensor]):
    """``a`` with each tensor replaced by its copy in ``copies``."""
    if isinstance(a, torch.Tensor):
        return copies[id(a)] if a.numel() else torch.empty_like(a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a)(*(_rebuild(getattr(a, f.name), copies) for f in dataclasses.fields(a)))
    if isinstance(a, (tuple, list)):
        return type(a)(_rebuild(v, copies) for v in a)
    return a


def owned(out):
    """``out`` (tensors, in tuples and dataclasses) with every tensor
    copied into one new buffer, by one concatenation: the caller owns the
    result, and later replays cannot change it. Tensors that share storage
    in ``out`` (the same object) share it in the copy too. Nothing else
    holds the buffer (the helpers are module functions, not closures that
    would hold themselves and their copies in a reference cycle): it is
    freed with the caller's last reference, not at the next run of the
    cyclic garbage collector."""
    seen: dict[int, torch.Tensor] = {}
    _collect(out, seen)
    # widest elements first, so that every piece's offset is aligned to its size
    ts = sorted(seen.values(), key=lambda t: -t.element_size())
    if not ts:
        return out
    buf = torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in ts])
    copies, off = {}, 0
    for t in ts:
        n = t.numel() * t.element_size()
        copies[id(t)] = buf[off : off + n].view(t.dtype).view(t.shape)
        off += n
    return _rebuild(out, copies)
