"""``sola_torch.utils.cuda_graphs.capture`` on a stand-in graph (the CPU
has no CUDA graphs): the capture's begin and end around the block, with
the garbage collector off inside and as it was after, also when the block
or the capture's end raises.

On a CUDA card (the tests taking ``cuda_card``, which skip here) a graph
left as garbage in a reference cycle survives another graph's capture, in
which allocations would have run a collection, and goes after it. This
file imports no JAX, so the card tests run on the card with
``python -m pytest --noconftest tests/test_torch_cuda_graphs.py``.
"""

import gc
import weakref

import pytest
import torch

from sola_torch.utils.cuda_graphs import capture


class FakeGraph:
    def __init__(self, fail_end: bool = False):
        self.calls = []
        self.fail_end = fail_end

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", pool, capture_error_mode,
                           gc.isenabled()))

    def capture_end(self):
        self.calls.append(("end", gc.isenabled()))
        if self.fail_end:
            raise RuntimeError("capture invalidated")


@pytest.fixture
def collector():
    was = gc.isenabled()
    yield
    if was:
        gc.enable()
    else:
        gc.disable()


@pytest.mark.parametrize("mode", ["global", "thread_local"])
@pytest.mark.parametrize("enabled", [True, False])
def test_capture_holds_the_collector_off(collector, enabled, mode):
    (gc.enable if enabled else gc.disable)()
    graph = FakeGraph()
    inside = []
    with capture(graph, "pool", mode=mode) as g:
        assert g is graph
        inside.append(gc.isenabled())
        graph.calls.append("body")
    assert graph.calls == [("begin", "pool", mode, False), "body",
                           ("end", False)]
    assert inside == [False]
    assert gc.isenabled() is enabled


@pytest.mark.parametrize("where", ["body", "end"])
def test_capture_restores_the_collector_when_it_raises(collector, where):
    gc.enable()
    graph = FakeGraph(fail_end=where == "end")
    with pytest.raises(RuntimeError):
        with capture(graph, None):
            if where == "body":
                raise RuntimeError("body failed")
    assert graph.calls[-1] == ("end", False)
    assert gc.isenabled()


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


class Marker:
    pass


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    return torch.device("cuda")


def captured(device, body, mode: str = "global") -> torch.cuda.CUDAGraph:
    """``body`` captured into a new graph on a side stream."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        with capture(graph, None, mode=mode):
            body()
    current.wait_stream(side)
    return graph


@pytest.mark.parametrize("mode", ["global", "thread_local"])
def test_a_graph_in_a_garbage_cycle_outlives_a_capture(cuda_card, collector,
                                                       mode):
    x = torch.arange(4.0, device=cuda_card)
    out = {}
    threshold = gc.get_threshold()
    gc.enable()
    gc.collect()
    # a graph that only a reference cycle keeps, in the youngest generation,
    # with a marker that tells whether the cycle is still there
    marker = Marker()
    alive = weakref.ref(marker)
    cycle = {"graph": captured(cuda_card, lambda: out.update(old=x * 2)),
             "marker": marker}
    cycle["self"] = cycle
    del cycle, marker

    def body():
        gc.set_threshold(1)   # each new container would run a collection
        [[] for _ in range(64)]
        out["new"] = x + 1
        out["alive_inside"] = alive() is not None

    try:
        graph = captured(cuda_card, body, mode)
    finally:
        gc.set_threshold(*threshold)
    x.fill_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert out["new"].tolist() == [2.0] * 4
    assert out["alive_inside"]   # no collection ran inside the capture
    gc.collect()
    assert alive() is None       # the cycle goes after it
