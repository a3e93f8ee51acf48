"""Whole solves as CUDA graphs: the loop closer's pose-graph solve and the
global BA's dispatches.

Each is a fixed number of iterations of a few thousand small torch ops at
static shapes; eagerly, the host's launches cost far more than the device's
work. On the card ``replay`` runs such a solve as one replay of a graph
captured at its first call with those shapes and settings, after a
warm-up run on a side stream; a failed capture raises and nothing falls
back to the eager path. Off the card the function runs eagerly.
"""

from __future__ import annotations

import torch

# (function, input shapes and dtypes, settings, device) ->
# (graph, static inputs, static outputs); a session meets a few shapes.
_GRAPHS: dict = {}
COUNTS = {"captures": 0, "replays": 0}


def _clone_tensors(tup):
    return type(tup)(*(x.clone() if isinstance(x, torch.Tensor) else x for x in tup))


def replay(fn, prob, *settings):
    """``fn(prob, *settings)``, ``prob`` a NamedTuple of tensors on one
    device and ``settings`` hashable numbers, returning a NamedTuple: on the
    card one graph replay on the current stream, ``prob`` copied into the
    graph's static inputs and the result copied out of its static outputs
    (its non-tensor fields as the capture left them)."""
    device = prob[0].device
    if device.type != "cuda":
        return fn(prob, *settings)
    key = (fn, tuple((tuple(x.shape), x.dtype) for x in prob), settings, device)
    entry = _GRAPHS.get(key)
    if entry is None:
        static = _clone_tensors(prob)
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(_clone_tensors(prob), *settings)  # warm-up: library handles, tables
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = fn(static, *settings)
        entry = _GRAPHS[key] = (graph, static, out)
        COUNTS["captures"] += 1
    graph, static, out = entry
    for dst, src in zip(static, prob):
        dst.copy_(src)
    graph.replay()
    COUNTS["replays"] += 1
    return _clone_tensors(out)
