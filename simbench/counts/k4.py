"""K4, the fused IGR decoder (``ops/csrc/igr_mlp.cu``): N points through
the MLP (float64 on the tensor cores' DMMA, hence its peak).

Operations per point: two per multiply-add of every layer and four per
Softplus activation. Bytes: the N x d_in inputs and every weight and bias
read once, the N values written once.
"""

from . import element_size

KERNEL = "igr_mlp_kernel"
PEAK = "float64_mma"
HOOK = ("diffsdfsim_torch.ops.igr_cuda", "igr_mlp", "run")


def sizes(params, x, *_, **__) -> dict:
    return dict(is64=int(x.element_size() == 8), N=int(x.shape[0]), d_in=int(x.shape[1]),
                layers=[tuple(int(d) for d in w.shape) for w in params.weights])


def count(s: dict):
    macs = sum(o * i for o, i in s["layers"])
    acts = sum(o for o, _ in s["layers"][:-1])
    params = sum(o * i + o for o, i in s["layers"])
    es = element_size(s["is64"])
    return s["N"] * (2.0 * macs + 4.0 * acts), (s["N"] * (s["d_in"] + 1) + params) * es
