"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side is imported inside the tests that use it, so the kernel tests
marked ``cuda`` also run where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.tree import tree_leaves

# The suite runs in several pytest-xdist worker processes at once; a torch
# intra-op pool as wide as the machine in every worker oversubscribes the
# cores, slows every file several times over and makes the host-timed
# cells flaky; the tests' small shapes gain nothing from more threads.
torch.set_num_threads(1)


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present; set the f32
    matmul precision the kernel comparisons assume (no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda is unavailable)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _captured_graph(fn):
    """A CUDA graph that captures one call of ``fn`` (its first-use work
    done on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # first-use work off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return graph


def _graph_nodes(graph):
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    return cuda, list(nodes)


def graph_kernel_nodes(fn) -> list:
    """Node types of a CUDA graph that captures one call of ``fn`` (0 is a
    kernel node): the device work a call enqueues, read through
    ``cuGraphGetNodes`` (libcuda) rather than from a profiler's trace."""
    import ctypes
    graph = _captured_graph(fn)
    cuda, nodes = _graph_nodes(graph)
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def graph_kernel_names(fn) -> list:
    """Function names of the kernel nodes of a CUDA graph of one call of
    ``fn`` (``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    import ctypes
    graph = _captured_graph(fn)
    cuda, nodes = _graph_nodes(graph)
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 256)()       # CUDA_KERNEL_NODE_PARAMS_v2
        name = ctypes.c_char_p()
        assert cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                  params) == 0
        assert cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(
            ctypes.c_void_p.from_buffer(params, 0).value)) == 0
        names.append(name.value.decode())
    return names


def to_numpy(tree):
    """JAX / torch value tree → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def assert_same_ints(a, b):
    """Integer artifacts: same dtype width, same shape, same bytes."""
    a, b = to_numpy(a), to_numpy(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype.itemsize == b.dtype.itemsize, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


def assert_trees_equal(a, b):
    """Two value trees with the same keys (and list lengths) and
    byte-identical leaves."""
    a, b = to_numpy(a), to_numpy(b)
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k])
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (len(a), len(b))
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def assert_close(a, b, *, tol):
    """f32 outputs within ``tol`` (rtol = atol = tol)."""
    np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=tol, atol=tol)


def assert_trees_close(a, b, *, tol, relative=False):
    """Two value trees with leaves of equal shapes within ``tol`` (rtol =
    atol = tol); ``relative`` scales atol by each leaf's largest |b|."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), (len(la), len(lb))
    for x, y in zip(la, lb):
        x, y = (to_numpy(t.float() if isinstance(t, torch.Tensor)
                         and t.dtype == torch.bfloat16 else t)
                .astype(np.float64) for t in (x, y))
        assert x.shape == y.shape, (x.shape, y.shape)
        atol = tol * max(float(np.abs(y).max(initial=0.0)), 1.0) \
            if relative else tol
        np.testing.assert_allclose(x, y, rtol=tol, atol=atol)


def rescale_fan_in(node):
    """A numpy param tree with every stacked weight ``w`` (L, in, out)
    rescaled to std 1/sqrt(in): the reference's stacked init takes the
    layer count as fan-in (ROADMAP queue C), and the residual stream it
    gives turns f32 comparisons into comparisons of rounding noise."""
    if isinstance(node, dict) and "w" in node and not isinstance(node["w"],
                                                                 dict):
        w = node["w"]
        return {**node, "w": (w * np.sqrt(w.shape[0] / w.shape[1]))
                .astype(w.dtype)}
    if isinstance(node, dict):
        return {k: rescale_fan_in(v) for k, v in node.items()}
    return node


def dequantize_tree(tree):
    """A served tree with every quantized leaf replaced by its effective
    f32 weight (``dequantize_leaf_ref``, each layer of a stacked leaf):
    the float model the dequant kernels and their twins compute."""
    from repro_torch.kernels.dequant import dequantize_leaf_ref
    if isinstance(tree, dict) and "codes" in tree:
        if tree["s"].ndim == 1:
            return dequantize_leaf_ref(tree)
        return torch.stack([dequantize_leaf_ref(tree, index=i)
                            for i in range(tree["s"].shape[0])])
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantize_tree(v) for v in tree]
    return tree


def load_leaves(tree, leaves):
    """Copy numpy ``leaves`` (``tree_leaves`` order) into the tensors of a
    torch ``tree`` in place; returns the tree."""
    from repro_torch.models import from_jax_params
    dst = tree_leaves(tree)
    assert len(dst) == len(leaves), (len(dst), len(leaves))
    for t, a in zip(dst, leaves):
        t.copy_(from_jax_params(np.asarray(a), t.device))
    return tree


def random_workload(seed, vocab, max_plen=8, max_budget=5):
    """(prompt, max_new_tokens, arrival step) triples: mixed lengths,
    budgets and staggered arrivals (tests/test_continuous_batching.py's
    ``_random_workload``)."""
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(4, 7))
    out = []
    for _ in range(n_req):
        plen = int(rng.integers(2, max_plen + 1))
        budget = int(rng.integers(1, max_budget + 1))
        arrival = int(rng.integers(0, 6))
        out.append((rng.integers(0, vocab, plen).astype(np.int32), budget,
                    arrival))
    return out


def drive_engine(eng, workload, continuous, request):
    """Static rounds: submit everything, run to the end.  Continuous:
    submit request i once its arrival step has run.  Returns {rid:
    token stream}."""
    if not continuous:
        for rid, (prompt, budget, _) in enumerate(workload):
            eng.submit(request(rid=rid, prompt=prompt.copy(),
                               max_new_tokens=budget))
        done = eng.run_until_done()
    else:
        pending = sorted(enumerate(workload), key=lambda kv: kv[1][2])
        done, steps = [], 0
        while pending or eng.queue or eng.active_slots:
            while pending and pending[0][1][2] <= steps:
                rid, (prompt, budget, _) = pending.pop(0)
                eng.submit(request(rid=rid, prompt=prompt.copy(),
                                   max_new_tokens=budget))
            done.extend(eng.step())
            steps += 1
            assert steps < 10_000
    assert len(done) == len(workload)
    return {r.rid: tuple(r.out_tokens) for r in done}
