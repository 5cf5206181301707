"""K4 wrapper: the fused IGR decoder as a hand-written CUDA kernel.

Replaces the Pallas kernel ``diffsdfsim_tpu/ops/pallas_kernels.py``
``igr_mlp_pallas``; the source is ``ops/csrc/igr_mlp.cu``. ``igr_mlp(params,
x)`` dispatches on the tensor's device alone: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version,
``models/igr.implicit_net_apply``.

On CUDA the launch sits in an autograd Function: its forward is the kernel,
its backward the vector-Jacobian product of the plain version with respect
to x, recomputed from the saved input (the JAX package has no backward
kernel either). The weights take no gradient: the decoder is frozen, and
a call whose weights require grad while grad mode is on raises rather than
return a result without their gradient (the CPU path would give one).

Under ``torch.func.vmap`` (a seed sweep's latent lane bodies query their
SDFs through a vmap of the single-body code, ``physics/bodies.py``) the
Function's vmap rule folds the lane axis into the point axis: the query of
all lanes is one launch over their points, and its backward one
vector-Jacobian product over them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..models.igr import ImplicitNetParams, implicit_net_apply

MAX_LAYERS = 32
NS = 32  # output columns of a slice, a CTA computes one or several (igr_mlp.cu NS)
KC = 16  # inputs per weight chunk (igr_mlp.cu KC)
TILES = (0, 8, 16, 32, 40)  # points per cluster; 0: the kernel's choice


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def pack_params(params: ImplicitNetParams):
    """The kernel's weight buffer, its per-layer (in, out, skip) dims and
    (w, b) offsets. A hidden layer's weight (out, in) is zero-padded to
    (round_up(out, NS), round_up(in, KC)) and cut into chunks of NS output
    rows by KC inputs, stored [slice][chunk][row][input]: the chunks of
    output slice ``sl``, which CTA ``sl % cluster size`` streams, in order,
    each contiguous. Its bias is zero-padded to round_up(out, NS). The last
    layer (one output) is its weight row zero-padded to round_up(in, KC),
    then its bias."""
    parts, dims, offs = [], [], []
    off = 0
    n_layers = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        w, b = w.detach(), b.detach()
        n_out, n_in = w.shape
        kp = _round_up(n_in, KC)
        dims += [n_in, n_out, int(i in params.skip_in)]
        if i < n_layers - 1:
            np_ = _round_up(n_out, NS)
            wp = torch.zeros((np_, kp), dtype=w.dtype, device=w.device)
            wp[:n_out, :n_in] = w
            tiles = wp.reshape(np_ // NS, NS, kp // KC, KC).permute(0, 2, 1, 3).reshape(-1)
            bp = torch.zeros((np_,), dtype=b.dtype, device=b.device)
            bp[:n_out] = b
        else:
            tiles = torch.zeros((kp,), dtype=w.dtype, device=w.device)
            tiles[:n_in] = w[0]
            bp = b.reshape(-1)
        offs += [off, off + tiles.numel()]
        parts += [tiles, bp]
        off += tiles.numel() + bp.numel()
    return torch.cat(parts).contiguous(), np.asarray(dims, dtype=np.int32), np.asarray(offs, dtype=np.int64)


def check_params(params: ImplicitNetParams, x):
    """Raise on a net or input the kernel does not take."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"IGR kernel takes float32 or float64, not {x.dtype}")
    if x.dim() != 2 or x.shape[1] != params.d_in:
        raise ValueError(f"IGR kernel: x must be (N, {params.d_in}), got {tuple(x.shape)}")
    if not 0 < len(params.weights) <= MAX_LAYERS or params.weights[-1].shape[0] != 1:
        raise ValueError("IGR kernel takes 1..32 layers ending in one output")
    width = params.d_in
    for i, w in enumerate(params.weights):
        if i in params.skip_in:
            width += params.d_in
        if w.shape[1] != width:
            raise ValueError(f"IGR kernel: layer {i} takes {w.shape[1]} inputs, the net gives {width}")
        if w.dtype != x.dtype or w.device != x.device:
            raise TypeError(f"IGR kernel: weights {w.dtype} on {w.device}, x {x.dtype} on {x.device}")
        width = w.shape[0]


class _IgrKernel:
    """Callable wrapper of the K4 launch; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._info = None
        self._packed = {}  # (weight storage, version) -> packed buffer

    def _lib_fn(self):
        if self._fn is None:
            from ._build import load

            lib = load("igr_mlp")
            fn = lib.igr_mlp
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 6
            info = lib.igr_mlp_info
            info.restype = ctypes.c_int
            info.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
            self._fn, self._info = fn, info
        return self._fn

    def __call__(self, params: ImplicitNetParams, x):
        """(N, d_in) -> (N,). The launch differentiates with respect to x
        only, so on CUDA it refuses weights that require grad while grad mode
        is on (a trainer calls ``implicit_net_apply``)."""
        if not x.is_cuda:
            return implicit_net_apply(params, x)
        if torch.is_grad_enabled() and any(t.requires_grad for t in params.weights + params.biases):
            raise ValueError("IGR kernel: the decoder's weights require grad, which the launch does not "
                             "differentiate; train through models.igr.implicit_net_apply")
        return _IgrMlp.apply(x, params, self)

    def _pack(self, params: ImplicitNetParams):
        tensors = params.weights + params.biases
        key = tuple((t.data_ptr(), t._version) for t in tensors) + (params.skip_in,)
        if key not in self._packed:
            if len(self._packed) >= 8:
                self._packed.clear()
            # the entry holds the weights, so their storage is not reused under its key
            self._packed[key] = (tensors, pack_params(params))
        return self._packed[key][1]

    def info(self, params: ImplicitNetParams, dtype, tile: int = 0, n: int = 1):
        """The launch's resources for this net: threads per CTA, cluster
        size, shared bytes per CTA, registers and local (spill) bytes per
        thread, CTAs per SM, points per cluster (``tile``; 0: the kernel's
        choice at n points), clusters the card runs at once, column slices
        per CTA."""
        self._lib_fn()
        _, dims, _ = self._pack(params)
        out = (ctypes.c_longlong * 9)()
        err = self._info(1 if dtype == torch.float64 else 0, tile, n, len(params.weights), params.d_in,
                         dims.ctypes.data, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"igr_mlp_info failed: CUDA error {err}")
        keys = ("threads", "cluster", "smem_bytes", "regs", "spill_bytes", "blocks_per_sm", "tile", "max_clusters",
                "slices")
        return dict(zip(keys, out))

    def run(self, params: ImplicitNetParams, x, tile: int = 0):
        """Validate, launch once on the current stream and return (N,).
        ``tile``: points per cluster, 8, 16, 32 or 40 (0: the kernel picks:
        32 or 40, whichever takes fewer waves of clusters at this N, where
        the net's activations fit a block's shared memory at 32 points; else
        16 or 8)."""
        check_params(params, x)
        if tile not in TILES:
            raise ValueError(f"IGR kernel: tile {tile} not one of {TILES}")
        x = x.detach().contiguous()
        prm, dims, offs = self._pack(params)
        n = x.shape[0]
        out = torch.empty((n,), dtype=x.dtype, device=x.device)
        err = self._lib_fn()(
            1 if x.dtype == torch.float64 else 0, tile, n, len(params.weights),
            params.d_in, float(params.beta), dims.ctypes.data, offs.ctypes.data, x.data_ptr(), prm.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"igr_mlp kernel launch failed: CUDA error {err} (a net whose activations do not "
                               f"fit a block's shared memory at 8 points is refused)")
        self.launches += 1
        return out


class _IgrMlp(torch.autograd.Function):
    """Forward: kernel K4. Backward: the plain version's vector-Jacobian
    product with respect to x. vmap: the mapped axes folded into the point
    axis, one launch (``kernel.run``) for all of them."""

    @staticmethod
    def forward(x, params, kernel):
        return kernel.run(params, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, params, _ = inputs
        ctx.params = params
        ctx.save_for_backward(x)

    @staticmethod
    def vmap(info, in_dims, x, params, kernel):
        x_dim, p_dims, _ = in_dims
        if x_dim is None or any(d is not None for d in p_dims.weights + p_dims.biases):
            raise ValueError("IGR kernel under vmap: the points carry the mapped axis, the decoder is shared")
        x = x.movedim(x_dim, 0)
        out = _IgrMlp.apply(x.reshape(-1, x.shape[-1]), params, kernel)
        return out.reshape(x.shape[:-1]), 0

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(implicit_net_apply(ctx.params, xd), xd, grad)
        return gx, None, None


igr_mlp = _IgrKernel()
