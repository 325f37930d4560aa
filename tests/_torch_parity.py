"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side is imported inside the tests that use it, so the kernel tests
marked ``cuda`` also run where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present; set the f32
    matmul precision the kernel comparisons assume (no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda is unavailable)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def graph_kernel_nodes(fn) -> list:
    """Node types of a CUDA graph that captures one call of ``fn`` (0 is a
    kernel node): the device work a call enqueues, read through
    ``cuGraphGetNodes`` (libcuda) rather than from a profiler's trace."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # first-use work off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def to_numpy(tree):
    """JAX / torch value tree → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
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
    """Two value trees with the same keys and byte-identical leaves."""
    a, b = to_numpy(a), to_numpy(b)
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k])
        return
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def assert_close(a, b, *, tol):
    """f32 outputs within ``tol`` (rtol = atol = tol)."""
    np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=tol, atol=tol)
