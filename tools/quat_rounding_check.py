#!/usr/bin/env python3
"""Check on the card that K3's corner formation rounds as the torch glue did.

    python3 tools/quat_rounding_check.py

fw_search.cu forms each face's corners in body 2's frame and the frames
R1, R2, d21 from the poses itself, with helpers that repeat
utils/quaternion.py's torch ops rounding for rounding (the quaternion norm's
pairwise FMA sums, cross products with the first product fused). This
script compiles those helpers (the source's "poses and corners" section)
into a small library, forms the corners and frames of the bench bodies at
64 poses reached by integrate_quat, and counts the entries that differ
from the torch expressions on the same card, float64 and float32, for
body 1 rotated, body 2 rotated and both. Every count must be 0; it exits
non-zero otherwise.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HARNESS = r'''
template <typename T>
__global__ void corners_kernel(int V, const T* verts, Poses<T> P, T* out, T* mats) {
  const int r = blockIdx.x;
  Frames<T> fr;
  make_frames(P, r, fr);
  for (int v = threadIdx.x; v < V; v += blockDim.x) cornered(P, r, fr, verts + 3 * v, out + ((size_t)r * V + v) * 3);
  if (threadIdx.x == 0)
    for (int i = 0; i < 9; ++i) {
      mats[r * 21 + i] = fr.R1[i];
      mats[r * 21 + 9 + i] = fr.R2[i];
    }
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) mats[r * 21 + 18 + i] = fr.d21[i];
}

template <typename T>
int run(int R, int V, const void* verts, const void* const* poses, const long long* s, void* out, void* mats) {
  Poses<T> P{(const T*)poses[0], (const T*)poses[1], (const T*)poses[2], (const T*)poses[3], {}};
  for (int i = 0; i < 8; ++i) P.s[i] = s[i];
  corners_kernel<T><<<R, 256>>>(V, (const T*)verts, P, (T*)out, (T*)mats);
  return (int)cudaDeviceSynchronize();
}
}  // namespace

extern "C" int corners(int dtype, int R, int V, const void* verts, const void* const* poses, const long long* s,
                       void* out, void* mats) {
  return dtype == 1 ? run<double>(R, V, verts, poses, s, out, mats) : run<float>(R, V, verts, poses, s, out, mats);
}
'''


def build(tmp):
    src = open(os.path.join(ROOT, "diffsdfsim_torch", "ops", "csrc", "fw_search.cu")).read()
    a = src.index("// ---------------------------------------------------------------- poses and corners")
    b = src.index("// ---------------------------------------------------------------- votes")
    head = src[src.index("template <typename T>\n__device__ __forceinline__ T sign_nz"):src.index("// box SDF")]
    path = os.path.join(tmp, "corners.cu")
    with open(path, "w") as f:
        f.write("#include <cuda_runtime.h>\n#include <math.h>\nnamespace {\n" + head + src[a:b] + HARNESS)
    lib = os.path.join(tmp, "libcorners.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, path], check=True)
    fn = ctypes.CDLL(lib).corners
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    return fn


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from diffsdfsim_torch.utils.quaternion import integrate_quat, quat_apply, quat_invert, quat_to_matrix

    if not torch.cuda.is_available():
        print("quat_rounding_check: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(tmp)
        for dtype in (torch.float64, torch.float32):
            floor, sphere = cs.bench_bodies("cuda", dtype)
            rng = np.random.default_rng(0)
            R = 64
            q = torch.tensor([[1.0, 0, 0, 0]] * R, dtype=torch.float64)
            for _ in range(30):
                q = integrate_quat(q, torch.tensor(rng.normal(size=(R, 3)) * 0.3), 1 / 30)
            q = q.to(dtype).cuda()
            pos = torch.tensor(rng.normal(size=(R, 3)), dtype=dtype, device="cuda")
            eye = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device="cuda").expand(R, 4)
            fp = torch.tensor([0.0, -0.5, 0.0], dtype=dtype, device="cuda").expand(R, 3)
            for label, bd, q1, p1, q2, p2 in (("sphere->floor", sphere, q, pos, eye, fp),
                                               ("floor->sphere", floor, eye, fp, q, pos),
                                               ("sphere->sphere", sphere, q, pos, q.flip(0), pos.flip(0))):
                ref = quat_apply(quat_invert(q2[:, None]), quat_apply(q1[:, None], bd.verts) + p1[:, None] - p2[:, None])
                refm = torch.cat([quat_to_matrix(q1).reshape(R, 9), quat_to_matrix(q2).reshape(R, 9), p2 - p1], 1)
                out, mats = torch.empty_like(ref), torch.empty_like(refm)
                strides = (ctypes.c_longlong * 8)(*(s for t in (q1, p1, q2, p2) for s in t.stride()))
                ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (q1, p1, q2, p2)))
                err = fn(1 if dtype == torch.float64 else 0, R, bd.verts.shape[0], bd.verts.data_ptr(), ptrs,
                         strides, out.data_ptr(), mats.data_ptr())
                assert err == 0, f"CUDA error {err}"
                nc, nm = int((out != ref).sum()), int((mats != refm).sum())
                bad += nc + nm
                print(f"{str(dtype)[6:]} {label}: corners {nc} of {out.numel()} differ, frames {nm} of {mats.numel()}")
    print("bitwise equal" if bad == 0 else f"{bad} entries differ")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
