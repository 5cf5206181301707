// K3: Frank-Wolfe contact search of one directed body pair at R poses.
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/fw_pallas.py
// `_make_kernel` (launched by `_fw_pallas_flat`, public `fw_search_pair`).
// For every face of body 1's surface mesh, expressed in body 2's local frame,
// the kernel runs the gradient-free contact search of the reference
// FWContactHandler (sdf_physics/physics3d/contacts.py:39-94, :161-214):
//
//   - the candidate gate (centroid SDF < circumradius + eps), min-corner init;
//   - up to `iters` Frank-Wolfe steps with the per-pair early stop ("all
//     improvements below tol" / "found sdf < -tol"), voted block-wide;
//   - the push onto body 1's surface and, when body 1 is an SDF body, the
//     contact-point polish (projected tangential descent, ops/polish.py);
//   - the contact test, the no-grad contact quantities (world normal,
//     world-oriented p1, penetration) and max_pen (-inf without a contact).
//
// It forms its own inputs: from body 1's vertices and faces, the R poses
// (q1, pos1, q2, pos2, any strides) and a small constant block per body
// (scale and kind parameters, built once per body by the wrapper) it
// computes each face's corners in body 2's frame and the frames R1, R2,
// d21, formula for formula as utils/quaternion.py's quat_apply, quat_invert
// and quat_to_matrix run on the card (each tensor op rounded on its own;
// `cornered` below), so the outputs are those of the plain glue's inputs.
//
// Layout: one face per thread up to FACE_CAP = 8192 faces. The R F faces
// are spread over the card's SMs, 64 to 256 a CTA (at most 512): a pose
// takes a thread-block cluster of up to 16 CTAs (at the bench's R = 3 the
// sphere's 320 faces take 5 CTAs, the floor's 768 faces 12). Each thread
// keeps its face's corners, Frank-Wolfe point and barycentrics in registers
// for the whole search. Past FACE_CAP faces (an icosphere at subdiv 5 has
// 20,480) a pose takes 16 CTAs of 512 threads and each thread loops over
// several faces, whose state waits in a scratch buffer between the phases
// (written and read back in whole warps, so L2 traffic, not registers,
// grows with F); the vote stays one per iteration for the whole pose. A Frank-Wolfe iteration ends in one barrier: each warp ORs
// "penetration found" and "still improving" into a flag word (a ring of
// three, so no second barrier clears it; in CTA 0's shared memory), and
// every thread then updates its own face. A non-candidate face skips the
// polish rounds, which would change none of its outputs.
//
// What bounds it on an H100: latency. One launch reads 9 corners per face
// and does ~40 iterations of a few hundred FLOPs per face: microseconds of
// FLOPs and bytes. The critical path is one candidate face's chain: the
// 10 polish rounds, each two SDF queries and a tangent step, a dozen
// dependent float64 square roots and divisions, which the rule "same
// arithmetic as the plain version" keeps. The design takes everything else
// off that path (no host glue, one barrier per vote, the frames formed
// while the vertices load, no slow path for a division of zero: `pdiv`) and
// runs all rungs of a pair and stage in one launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NBODY = 8;  // per-body constants: scale, prm[4], padding
constexpr int MAX_THREADS = 512;  // up to 128 registers a thread
constexpr int MAX_CS = 16;        // past 8 CTAs a non-portable cluster size
constexpr int FACE_CAP = MAX_THREADS * MAX_CS;  // faces a pose runs one per thread
constexpr int NUM_SMS = 132;  // H100 SXM
constexpr int KIND_NONE = -1, KIND_SPHERE = 0, KIND_BOX = 1, KIND_ROUNDED_BOX = 2,
              KIND_CYLINDER = 3, KIND_BRICK = 4;

template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) { return sqrt(fmax(x, (T)1e-24)); }

template <typename T>
__device__ __forceinline__ T norm3(T a, T b, T c) { return safe_sqrt(a * a + b * b + c * c); }

template <typename T>
__device__ __forceinline__ T sign_nz(T x) { return x >= 0 ? (T)1 : (T)-1; }

// a / b for a positive b (a norm, a count): the same bits as a / b, but a
// zero dividend, the common case in the box gradients, is returned as it is
// rather than sent down the float64 division's slow path, several times
// longer than its fast one
template <typename T>
__device__ __forceinline__ T pdiv(T a, T b) { return a == (T)0 ? a : a / b; }

// box SDF and failsafe gradient for half extents (h0, h1, h2)
template <typename T>
__device__ void box_sdf_grad(T h0, T h1, T h2, T x, T y, T z, T& sdf, T* g) {
  const T q0 = fabs(x) - h0, q1 = fabs(y) - h1, q2 = fabs(z) - h2;
  const T maxd = fmax(fmax(q0, q1), q2);
  const T m0 = fmax(q0, (T)0), m1 = fmax(q1, (T)0), m2 = fmax(q2, (T)0);
  const T nrm = norm3(m0, m1, m2);
  sdf = nrm + fmin(maxd, (T)0);
  const T inside = maxd <= 0 ? (T)1 : (T)0;
  g[0] = (pdiv(m0, nrm) + inside * (q0 == maxd ? (T)1 : (T)0)) * sign_nz(x);
  g[1] = (pdiv(m1, nrm) + inside * (q1 == maxd ? (T)1 : (T)0)) * sign_nz(y);
  g[2] = (pdiv(m2, nrm) + inside * (q2 == maxd ? (T)1 : (T)0)) * sign_nz(z);
}

// normalized-frame SDF + (unnormalized) gradient of one analytic primitive;
// formula for formula the JAX kernel's _prim_sdf_grad (fw_pallas.py:84)
template <typename T, int KIND>
__device__ void prim_sdf_grad(const T* prm, T x, T y, T z, T& sdf, T* g) {
  if (KIND == KIND_SPHERE) {
    sdf = norm3(x, y, z) - prm[0];
    g[0] = x;
    g[1] = y;
    g[2] = z;
  } else if (KIND == KIND_BOX) {
    box_sdf_grad(prm[0] * (T)0.5, prm[1] * (T)0.5, prm[2] * (T)0.5, x, y, z, sdf, g);
  } else if (KIND == KIND_ROUNDED_BOX) {
    box_sdf_grad(prm[1] * (T)0.5, prm[2] * (T)0.5, prm[3] * (T)0.5, x, y, z, sdf, g);
    sdf = sdf - prm[0];
  } else if (KIND == KIND_CYLINDER) {
    const T rad = prm[0], height = prm[1];
    const T r_xy = safe_sqrt(x * x + y * y);
    const T q0 = r_xy - rad, q1 = fabs(z) - height * (T)0.5;
    const T maxd = fmax(q0, q1);
    const T m0 = fmax(q0, (T)0), m1 = fmax(q1, (T)0);
    const T nrm = safe_sqrt(m0 * m0 + m1 * m1);
    sdf = nrm + fmin(maxd, (T)0);
    const T inside = maxd <= 0 ? (T)1 : (T)0;
    const T g2d0 = pdiv(m0, nrm) + inside * (q0 == maxd ? (T)1 : (T)0);
    const T g2d1 = pdiv(m1, nrm) + inside * (q1 == maxd ? (T)1 : (T)0);
    const T inv_rxy = (T)1 / r_xy;
    g[0] = g2d0 * x * inv_rxy;
    g[1] = g2d0 * y * inv_rxy;
    g[2] = g2d1 * sign_nz(z);
  } else {  // KIND_BRICK: prm = (d0, d1, d2, r)
    const T d0 = prm[0], d1 = prm[1], d2 = prm[2], r = prm[3];
    const T q0 = fabs(x) - (d0 * (T)0.5 - r), q1 = fabs(y) - (d1 * (T)0.5 - r);
    const T q2 = fabs(z) - d2 * (T)0.5;
    const T max01 = fmax(q0, q1);
    const T m0 = fmax(q0, (T)0), m1 = fmax(q1, (T)0);
    const T sdf01 = safe_sqrt(m0 * m0 + m1 * m1) + fmin(max01, (T)0) - r;
    const T ma = fmax(sdf01, (T)0), mb = fmax(q2, (T)0);
    sdf = safe_sqrt(ma * ma + mb * mb) + fmin(fmax(sdf01, q2), (T)0);
    T unused;
    box_sdf_grad(d0 * (T)0.5, d1 * (T)0.5, d2 * (T)0.5, x, y, z, unused, g);  // outer-dims failsafe
  }
}

// metric local-frame query: bounding-scale mask, metric sdf, normalized
// masked gradient (physics/shapes.py query_sdfs)
template <typename T, int KIND>
__device__ T query(T scale, const T* prm, T x, T y, T z, T* g) {
  const bool ov = fabs(x) <= scale && fabs(y) <= scale && fabs(z) <= scale;
  const T inv_s = (T)1 / scale;
  T sdf_n, gg[3];
  prim_sdf_grad<T, KIND>(prm, x * inv_s, y * inv_s, z * inv_s, sdf_n, gg);
  if (g) {
    const T n = norm3(gg[0], gg[1], gg[2]);
    for (int c = 0; c < 3; ++c) g[c] = ov ? pdiv(gg[c], n) : (T)0;
  }
  return (ov ? sdf_n : (T)1) * scale;
}

// ---------------------------------------------------------------- poses and corners

// correctly rounded operations, never contracted into an FMA: each stands
// for one tensor op of utils/quaternion.py
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// q / |q| for a wxyz quaternion at stride s. torch.linalg.norm over the 4
// components on the card sums (q0^2 + q2^2) + (q1^2 + q3^2), each pair as
// one FMA onto the rounded first square (matched bitwise on an H100)
template <typename T>
__device__ void quat_normalize(const T* q, long long s, T* out) {
  const T a = q[0], b = q[s], c = q[2 * s], d = q[3 * s];
  const T n2 = add_rn(fma(c, c, mul_rn(a, a)), fma(d, d, mul_rn(b, b)));
  const T n = sqrt(n2);
  out[0] = pdiv(a, n);
  out[1] = pdiv(b, n);
  out[2] = pdiv(c, n);
  out[3] = pdiv(d, n);
}

// one component of a x b, a1 b2 - a2 b1, as torch.linalg.cross's kernel
// rounds it: the second product rounded, the first fused into the subtraction
template <typename T>
__device__ __forceinline__ T cross_c(T a1, T b2, T a2, T b1) {
  return fma(a1, b2, -mul_rn(a2, b1));
}

// quat_apply(q, p) = p + 2 (w (u x p) + u x (u x p)) for a normalized q
template <typename T>
__device__ void quat_apply(const T* q, const T* p, T* out) {
  const T u[3] = {q[1], q[2], q[3]};
  T uv[3], uuv[3];
  uv[0] = cross_c(u[1], p[2], u[2], p[1]);
  uv[1] = cross_c(u[2], p[0], u[0], p[2]);
  uv[2] = cross_c(u[0], p[1], u[1], p[0]);
  uuv[0] = cross_c(u[1], uv[2], u[2], uv[1]);
  uuv[1] = cross_c(u[2], uv[0], u[0], uv[2]);
  uuv[2] = cross_c(u[0], uv[1], u[1], uv[0]);
  for (int c = 0; c < 3; ++c) out[c] = add_rn(p[c], mul_rn((T)2, add_rn(mul_rn(q[0], uv[c]), uuv[c])));
}

// quat_to_matrix of a normalized q, row-major
template <typename T>
__device__ void quat_to_matrix(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3], two = 2;
  R[0] = sub_rn((T)1, mul_rn(two, add_rn(mul_rn(y, y), mul_rn(z, z))));
  R[1] = mul_rn(two, sub_rn(mul_rn(x, y), mul_rn(w, z)));
  R[2] = mul_rn(two, add_rn(mul_rn(x, z), mul_rn(w, y)));
  R[3] = mul_rn(two, add_rn(mul_rn(x, y), mul_rn(w, z)));
  R[4] = sub_rn((T)1, mul_rn(two, add_rn(mul_rn(x, x), mul_rn(z, z))));
  R[5] = mul_rn(two, sub_rn(mul_rn(y, z), mul_rn(w, x)));
  R[6] = mul_rn(two, sub_rn(mul_rn(x, z), mul_rn(w, y)));
  R[7] = mul_rn(two, add_rn(mul_rn(y, z), mul_rn(w, x)));
  R[8] = sub_rn((T)1, mul_rn(two, add_rn(mul_rn(x, x), mul_rn(y, y))));
}

// the R poses: pointer and (row, component) strides of each, in elements
template <typename T>
struct Poses {
  const T *q1, *pos1, *q2, *pos2;
  long long s[8];
};

// one pose's frames and normalized quaternions, formed once per CTA
template <typename T>
struct Frames {
  T R1[9], R2[9], d21[3], R12[3][3], t12[3], q1n[4], q2in[4];
  __device__ void to_b1(const T* x, T* out) const {
    for (int i = 0; i < 3; ++i) out[i] = R12[i][0] * x[0] + R12[i][1] * x[1] + R12[i][2] * x[2] + t12[i];
  }
  __device__ void to_b2(const T* y, T* out) const {  // inverse of to_b1
    for (int c = 0; c < 3; ++c)
      out[c] = R12[0][c] * (y[0] - t12[0]) + R12[1][c] * (y[1] - t12[1]) + R12[2][c] * (y[2] - t12[2]);
  }
  __device__ void dir_to_b2(const T* v, T* out) const {  // R12' v
    for (int c = 0; c < 3; ++c) out[c] = R12[0][c] * v[0] + R12[1][c] * v[1] + R12[2][c] * v[2];
  }
};

template <typename T>
__device__ void make_frames(const Poses<T>& P, int r, Frames<T>& fr) {
  const T* q1 = P.q1 + r * P.s[0];
  const T* p1 = P.pos1 + r * P.s[2];
  const T* q2 = P.q2 + r * P.s[4];
  const T* p2 = P.pos2 + r * P.s[6];
  T q2n[4];
  quat_normalize(q1, P.s[1], fr.q1n);
  quat_normalize(q2, P.s[5], q2n);
  quat_to_matrix(fr.q1n, fr.R1);
  quat_to_matrix(q2n, fr.R2);
  // quat_invert then normalize: the norm of the conjugate is the norm of q2
  fr.q2in[0] = q2n[0];
  for (int i = 1; i < 4; ++i) fr.q2in[i] = -q2n[i];
  for (int i = 0; i < 3; ++i) fr.d21[i] = sub_rn(p2[i * P.s[7]], p1[i * P.s[3]]);
  // R12 = R1' R2 (body-2 local -> body-1 local), t12 = R1' (p2 - p1)
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      fr.R12[i][j] = fr.R1[i] * fr.R2[j] + fr.R1[3 + i] * fr.R2[3 + j] + fr.R1[6 + i] * fr.R2[6 + j];
    fr.t12[i] = fr.R1[i] * fr.d21[0] + fr.R1[3 + i] * fr.d21[1] + fr.R1[6 + i] * fr.d21[2];
  }
}

// a vertex of body 1 in body 2's frame: quat_apply(q2^-1, quat_apply(q1, v) + pos1 - pos2)
template <typename T>
__device__ void cornered(const Poses<T>& P, int r, const Frames<T>& fr, const T* v, T* out) {
  T w[3];
  quat_apply(fr.q1n, v, w);
  const T* p1 = P.pos1 + r * P.s[2];
  const T* p2 = P.pos2 + r * P.s[6];
  for (int c = 0; c < 3; ++c) w[c] = sub_rn(add_rn(w[c], p1[c * P.s[3]]), p2[c * P.s[7]]);
  quat_apply(fr.q2in, w, out);
}

// ---------------------------------------------------------------- votes

// OR of `bits` over the pose's threads (its CTA or cluster), at one barrier:
// warps OR into flag word n % 3 (in CTA 0), CTA 0's thread 0 clears the word
// of the next vote before the barrier (the word of two votes ago, which
// every thread has read before it reached the last barrier)
struct Vote {
  int* flags;  // CTA 0's three flag words
  int n, cs;
  bool lead;
  __device__ int operator()(int bits, const cg::cluster_group& cluster) {
    const int slot = n % 3;
    bits = (int)__reduce_or_sync(0xffffffffu, (unsigned)bits);
    if ((threadIdx.x & 31) == 0 && bits) atomicOr(&flags[slot], bits);
    if (lead) flags[(slot + 1) % 3] = 0;
    if (cs > 1)
      cluster.sync();
    else
      __syncthreads();
    ++n;
    return flags[slot];
  }
};

constexpr int VOTE_PEN = 1, VOTE_IMPROVING = 2;

// ---------------------------------------------------------------- the kernel

template <typename T>
struct Outs {
  T *abc, *nrm, *p1, *x1, *pen, *mp;
  uint8_t *cand, *cmask;
  int32_t* iters;
};

template <typename T>
__device__ __forceinline__ T pick(int m, T a, T b, T c) {
  return m == 0 ? a : (m == 1 ? b : c);
}

// one face's search state: corners in body 2's frame, Frank-Wolfe point and
// barycentrics, circumradius, candidate flag
template <typename T>
struct Face {
  T p[3][3], x[3], a[3], rad;
  bool cand;
};

// the shape constants of both bodies
template <typename T, int K1>
struct Bodies {
  T s1, s2, prm1[4], prm2[4];
  __device__ Bodies(const T* c1, const T* c2) {
    constexpr bool b1_sdf = K1 != KIND_NONE;
    s1 = b1_sdf ? c1[0] : (T)1;
    s2 = c2[0];
    for (int i = 0; i < 4; ++i) {
      prm1[i] = b1_sdf ? c1[1 + i] : (T)0;
      prm2[i] = c2[1 + i];
    }
  }
};

// face f's vertices in body 1's frame
template <typename T>
__device__ __forceinline__ void load_vertices(const T* verts, const int64_t* faces, int f, T (&vtx)[3][3]) {
  for (int v = 0; v < 3; ++v) {
    const T* src = verts + 3 * faces[3 * f + v];
    for (int c = 0; c < 3; ++c) vtx[v][c] = src[c];
  }
}

// corners, candidate gate (contacts.py:44-52) and min-corner init (:57-61)
template <typename T, int K1, int K2>
__device__ void face_init(const Poses<T>& P, int r, const Frames<T>& fr, const T (&vtx)[3][3], const Bodies<T, K1>& B,
                          T eps, Face<T>& st) {
  for (int v = 0; v < 3; ++v) cornered(P, r, fr, vtx[v], st.p[v]);
  const T(&p)[3][3] = st.p;
  T cen[3], g[3];
  for (int c = 0; c < 3; ++c) cen[c] = pdiv(p[0][c] + p[1][c] + p[2][c], (T)3);
  const T csdf = query<T, K2>(B.s2, B.prm2, cen[0], cen[1], cen[2], g);
  T rad = 0;
  for (int v = 0; v < 3; ++v) rad = fmax(rad, norm3(cen[0] - p[v][0], cen[1] - p[v][1], cen[2] - p[v][2]));
  st.rad = rad;
  st.cand = csdf < rad + eps && sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) > (T)1e-12;
  T cs3[3];
  for (int v = 0; v < 3; ++v) cs3[v] = query<T, K2>(B.s2, B.prm2, p[v][0], p[v][1], p[v][2], nullptr);
  const int i0 = (cs3[0] <= cs3[1] && cs3[0] <= cs3[2]) ? 0 : (cs3[1] <= cs3[2] ? 1 : 2);
  for (int c = 0; c < 3; ++c) {
    st.x[c] = pick(i0, p[0][c], p[1][c], p[2][c]);
    st.a[c] = i0 == c ? (T)1 : (T)0;
  }
}

// one Frank-Wolfe evaluation of a face (contacts.py:63-78): the LMO corner
// m, the step gam and the face's vote bits
template <typename T, int K1, int K2>
__device__ int face_eval(const Face<T>& st, int it, const Bodies<T, K1>& B, T tol, int& m, T& gam) {
  const T(&p)[3][3] = st.p;
  const T gamma = (T)2 / ((T)it + (T)2);
  T g[3];
  const T sdf = query<T, K2>(B.s2, B.prm2, st.x[0], st.x[1], st.x[2], g);
  T dv[3];
  for (int v = 0; v < 3; ++v) dv[v] = p[v][0] * g[0] + p[v][1] * g[1] + p[v][2] * g[2];
  m = (dv[0] <= dv[1] && dv[0] <= dv[2]) ? 0 : (dv[1] <= dv[2] ? 1 : 2);
  T impr = 0;
  for (int c = 0; c < 3; ++c) impr += (st.x[c] - pick(m, p[0][c], p[1][c], p[2][c])) * g[c];
  gam = (st.cand && fabs(impr) > tol) ? gamma : (T)0;
  return (st.cand && sdf < -tol ? VOTE_PEN : 0) | (gam != (T)0 ? VOTE_IMPROVING : 0);
}

template <typename T>
__device__ __forceinline__ void face_step(Face<T>& st, int m, T gam) {
  for (int c = 0; c < 3; ++c) {
    st.x[c] = ((T)1 - gam) * st.x[c] + gam * pick(m, st.p[0][c], st.p[1][c], st.p[2][c]);
    st.a[c] = st.a[c] * ((T)1 - gam) + gam * (m == c ? (T)1 : (T)0);
  }
}

// push, polish, contact test and contact quantities of face f (contacts.py
// :84-94, ops/polish.py); writes its outputs and returns its contact mask,
// its penetration in `pen`
template <typename T, int K1, int K2>
__device__ bool face_finish(const Face<T>& st, int f, int r, int F, bool any_cand, const Frames<T>& fr,
                            const Bodies<T, K1>& B, T eps, int polish_iters, const Outs<T>& O, T& pen) {
  constexpr bool b1_sdf = K1 != KIND_NONE;
  const bool polish = b1_sdf && polish_iters > 0;
  const T(&x)[3] = st.x;
  const T rad = st.rad;
  const bool cand = st.cand;
  T xf[3] = {x[0], x[1], x[2]};
  T g[3], tmp[3], tmp2[3];
  if (b1_sdf) {
    fr.to_b1(x, tmp);
    const T s1v = query<T, K1>(B.s1, B.prm1, tmp[0], tmp[1], tmp[2], g);
    fr.dir_to_b2(g, tmp2);
    for (int c = 0; c < 3; ++c) xf[c] = x[c] - s1v * tmp2[c];
  }
  T cb1[3], bx[3] = {0, 0, 0}, fsdf;
  if (polish) {
    T xb1[3];
    fr.to_b1(xf, xb1);
    const T s1b = query<T, K1>(B.s1, B.prm1, xb1[0], xb1[1], xb1[2], g);
    for (int c = 0; c < 3; ++c) bx[c] = xb1[c] - s1b * g[c];
    fr.to_b2(bx, tmp);
    T bs2 = query<T, K2>(B.s2, B.prm2, tmp[0], tmp[1], tmp[2], nullptr);
    T px[3] = {xf[0], xf[1], xf[2]};
    T eta_f = 1;
    // a non-candidate face's rounds change neither bx nor bs2: skip them
    for (int k = 0; cand && k < polish_iters; ++k) {
      T x1c[3], g1[3], x1p[3], xp[3], g2[3], n1[3];
      fr.to_b1(px, x1c);
      const T s1v = query<T, K1>(B.s1, B.prm1, x1c[0], x1c[1], x1c[2], g1);
      for (int c = 0; c < 3; ++c) x1p[c] = x1c[c] - s1v * g1[c];
      fr.to_b2(x1p, xp);
      const T s2v = query<T, K2>(B.s2, B.prm2, xp[0], xp[1], xp[2], g2);
      if (s2v < bs2) {
        for (int c = 0; c < 3; ++c) bx[c] = x1p[c];
        bs2 = s2v;
      }
      fr.dir_to_b2(g1, n1);
      const T dt = g2[0] * n1[0] + g2[1] * n1[1] + g2[2] * n1[2];
      T t[3];
      for (int c = 0; c < 3; ++c) t[c] = g2[c] - dt * n1[c];
      const T tl = norm3(t[0], t[1], t[2]);
      const T eta = rad * eta_f;
      for (int c = 0; c < 3; ++c) px[c] = xp[c] - eta * pdiv(t[c], tl);
      eta_f = eta_f * (T)0.5;
    }
    fsdf = bs2;
    const T pd1 = query<T, K1>(B.s1, B.prm1, bx[0], bx[1], bx[2], g);
    for (int c = 0; c < 3; ++c) cb1[c] = bx[c] - pd1 * g[c];
  } else {
    fsdf = query<T, K2>(B.s2, B.prm2, xf[0], xf[1], xf[2], nullptr);
    fr.to_b1(x, cb1);
    if (b1_sdf) {
      const T pd1 = query<T, K1>(B.s1, B.prm1, cb1[0], cb1[1], cb1[2], g);
      for (int c = 0; c < 3; ++c) cb1[c] = cb1[c] - pd1 * g[c];
    }
  }
  const bool cmask = any_cand && cand && fsdf <= eps;
  // p1 world offset = R1 cb1; contact point in body 2: R2' (p1w - d21)
  T p1w[3], w[3], cb2[3], n2[3], nrm[3];
  for (int i = 0; i < 3; ++i) p1w[i] = fr.R1[3 * i] * cb1[0] + fr.R1[3 * i + 1] * cb1[1] + fr.R1[3 * i + 2] * cb1[2];
  for (int i = 0; i < 3; ++i) w[i] = p1w[i] - fr.d21[i];
  for (int i = 0; i < 3; ++i) cb2[i] = fr.R2[i] * w[0] + fr.R2[3 + i] * w[1] + fr.R2[6 + i] * w[2];
  const T d2v = query<T, K2>(B.s2, B.prm2, cb2[0], cb2[1], cb2[2], n2);
  for (int i = 0; i < 3; ++i) nrm[i] = fr.R2[3 * i] * n2[0] + fr.R2[3 * i + 1] * n2[1] + fr.R2[3 * i + 2] * n2[2];
  pen = -d2v;

  const size_t o3 = (size_t)r * 3 * F, o1 = (size_t)r * F;
  for (int c = 0; c < 3; ++c) {
    // a pose without any candidate reports all zeros (contacts.py:292-301)
    O.abc[o3 + c * F + f] = any_cand ? st.a[c] : (T)0;
    O.nrm[o3 + c * F + f] = cmask ? nrm[c] : (T)0;
    O.p1[o3 + c * F + f] = cmask ? p1w[c] : (T)0;
    O.x1[o3 + c * F + f] = (polish && any_cand) ? bx[c] : (T)0;
  }
  O.pen[o1 + f] = cmask ? pen : (T)-1;
  O.cand[o1 + f] = cand;
  O.cmask[o1 + f] = cmask;
  return cmask;
}

// The state of faces beyond one a thread (F > FACE_CAP) between the phases:
// NSTATE arrays of R F values (corners, point, barycentrics, radius,
// candidate flag, the iteration's LMO corner and step), one value of a face
// after another, so a warp's faces are contiguous
constexpr int NSTATE = 19;
template <typename T>
struct Store {
  T* s;
  size_t n;  // R F
  __device__ void put(size_t i, const Face<T>& st) const {
    for (int v = 0; v < 3; ++v)
      for (int c = 0; c < 3; ++c) s[(3 * v + c) * n + i] = st.p[v][c];
    for (int c = 0; c < 3; ++c) {
      s[(9 + c) * n + i] = st.x[c];
      s[(12 + c) * n + i] = st.a[c];
    }
    s[15 * n + i] = st.rad;
    s[16 * n + i] = st.cand ? (T)1 : (T)0;
  }
  __device__ void get(size_t i, Face<T>& st) const {
    for (int v = 0; v < 3; ++v)
      for (int c = 0; c < 3; ++c) st.p[v][c] = s[(3 * v + c) * n + i];
    for (int c = 0; c < 3; ++c) {
      st.x[c] = s[(9 + c) * n + i];
      st.a[c] = s[(12 + c) * n + i];
    }
    st.rad = s[15 * n + i];
    st.cand = s[16 * n + i] != (T)0;
  }
};

// MULTI = false: one face per thread, its state in registers for the whole
// search. MULTI = true (F > FACE_CAP): a pose's cluster of MAX_CS CTAs of
// MAX_THREADS threads loops over its faces, thread t taking faces t, t +
// MAX_CS MAX_THREADS, ...; their state lives in `state` between the phases,
// and each Frank-Wolfe iteration is still one vote of the whole pose.
template <typename T, int K1, int K2, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS)
fw_search_kernel(int F, int iters, int polish_iters, T eps, T tol, const T* __restrict__ verts,
                 const int64_t* __restrict__ faces, Poses<T> P, const T* __restrict__ c1,
                 const T* __restrict__ c2, Outs<T> O, T* __restrict__ state) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r = blockIdx.x / cs;
  const int f0 = rank * blockDim.x + threadIdx.x, stride = cs * blockDim.x;
  const bool has_face = f0 < F;
  Frames<T>& fr = *reinterpret_cast<Frames<T>*>(smem_raw);
  T* red = reinterpret_cast<T*>(smem_raw + (sizeof(Frames<T>) + 15) / 16 * 16);  // cs x 32 warp maxima
  int* flags_local = reinterpret_cast<int*>(red + MAX_CS * 32);
  Vote vote{cs > 1 ? cluster.map_shared_rank(flags_local, 0) : flags_local, 0, cs,
            rank == 0 && threadIdx.x == 0};

  // the face's vertices (body 1's frame), loaded while thread 0 forms the frames
  T vtx[3][3];
  if (!MULTI && has_face) load_vertices(verts, faces, f0, vtx);
  if (threadIdx.x == 0) {
    make_frames(P, r, fr);
    if (rank == 0)
      for (int i = 0; i < 3; ++i) flags_local[i] = 0;
  }
  if (cs > 1)
    cluster.sync();  // also: every CTA of the cluster has started before one touches another's memory
  else
    __syncthreads();

  const Bodies<T, K1> B(c1, c2);
  const Store<T> S{state, (size_t)gridDim.x / cs * F};
  const size_t base = (size_t)r * F;
  Face<T> st;
  bool cand_any = false;
  if (!MULTI) {
    if (has_face) {
      face_init<T, K1, K2>(P, r, fr, vtx, B, eps, st);
      cand_any = st.cand;
    }
  } else {
    for (int f = f0; f < F; f += stride) {
      load_vertices(verts, faces, f, vtx);
      face_init<T, K1, K2>(P, r, fr, vtx, B, eps, st);
      S.put(base + f, st);
      cand_any = cand_any || st.cand;
    }
  }
  const bool any_cand = vote(cand_any ? 1 : 0, cluster) != 0;

  // Frank-Wolfe loop (contacts.py:63-82): per-face LMO step, stopped for the
  // whole pair when no face improves or a penetration is found
  int it = 0, evaluated = 0;
  for (; any_cand && it < iters; ++it) {
    evaluated = it + 1;
    int bits = 0, m = 0;
    T gam = 0;
    if (!MULTI) {
      if (has_face) bits = face_eval<T, K1, K2>(st, it, B, tol, m, gam);
    } else {
      for (int f = f0; f < F; f += stride) {
        S.get(base + f, st);
        bits |= face_eval<T, K1, K2>(st, it, B, tol, m, gam);
        S.s[17 * S.n + base + f] = (T)m;
        S.s[18 * S.n + base + f] = gam;
      }
    }
    bits = vote(bits, cluster);
    if ((bits & VOTE_PEN) || !(bits & VOTE_IMPROVING)) break;
    if (!MULTI) {
      if (has_face) face_step(st, m, gam);
    } else {
      for (int f = f0; f < F; f += stride) {
        S.get(base + f, st);
        face_step(st, (int)S.s[17 * S.n + base + f], S.s[18 * S.n + base + f]);
        S.put(base + f, st);
      }
    }
  }

  // push, polish, contact test, contact quantities (per face)
  T local_max = -(T)INFINITY, pen;
  if (!MULTI) {
    if (has_face && face_finish<T, K1, K2>(st, f0, r, F, any_cand, fr, B, eps, polish_iters, O, pen))
      local_max = fmax(local_max, pen);
  } else {
    for (int f = f0; f < F; f += stride) {
      S.get(base + f, st);
      if (face_finish<T, K1, K2>(st, f, r, F, any_cand, fr, B, eps, polish_iters, O, pen))
        local_max = fmax(local_max, pen);
    }
  }

  // max_pen: warp maxima into CTA 0, one barrier, CTA 0's thread 0 reduces
  for (int o = 16; o > 0; o >>= 1) local_max = fmax(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
  const int nw = blockDim.x / 32;
  T* red0 = cs > 1 ? cluster.map_shared_rank(red, 0) : red;
  if ((threadIdx.x & 31) == 0) red0[rank * nw + threadIdx.x / 32] = local_max;
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank == 0 && threadIdx.x == 0) {
    T mp = red[0];
    for (int i = 1; i < cs * nw; ++i) mp = fmax(mp, red[i]);
    O.mp[r] = mp;
    O.iters[r] = evaluated;  // FW iterations evaluated (for the bound in chip_smoke.py)
  }
}

// ---------------------------------------------------------------- launch

template <typename T>
size_t smem_bytes() {
  return (sizeof(Frames<T>) + 15) / 16 * 16 + MAX_CS * 32 * sizeof(T) + 3 * sizeof(int);
}

// threads per CTA and CTAs per pose for R poses of F faces: the R F faces
// spread over the card's SMs, 64 to 256 a CTA (a few poses take several SMs
// each; many poses keep several CTAs on an SM); past FACE_CAP faces a pose
// takes the largest cluster, MAX_CS CTAs of MAX_THREADS, each thread
// several faces
void geometry(int R, int F, int& threads, int& cs) {
  if (F > FACE_CAP) {
    threads = MAX_THREADS;
    cs = MAX_CS;
    return;
  }
  const long long share = ((long long)R * F + NUM_SMS - 1) / NUM_SMS;
  const int per_cta = share < 64 ? 64 : (share > 256 ? 256 : (int)share);
  cs = (F + per_cta - 1) / per_cta;
  cs = cs > MAX_CS ? MAX_CS : cs;
  threads = ((F + cs - 1) / cs + 31) / 32 * 32;
}

// the output buffer: abc, normal, p1, x1 (R, 3, F), pen (R, F), max_pen (R,)
// in T; then, 16-byte aligned, cand and cmask (R, F) bytes; then, 4-byte
// aligned, the FW iterations run (R,) int32
template <typename T>
Outs<T> out_views(void* buf, int R, int F) {
  Outs<T> o;
  T* t = (T*)buf;
  const size_t n3 = (size_t)R * 3 * F, n1 = (size_t)R * F;
  o.abc = t;
  o.nrm = t + n3;
  o.p1 = t + 2 * n3;
  o.x1 = t + 3 * n3;
  o.pen = t + 4 * n3;
  o.mp = t + 4 * n3 + n1;
  uint8_t* b = (uint8_t*)buf + ((4 * n3 + n1 + R) * sizeof(T) + 15) / 16 * 16;
  o.cand = b;
  o.cmask = b + n1;
  o.iters = (int32_t*)(b + (2 * n1 + 3) / 4 * 4);
  return o;
}

struct Args {
  int R, F, iters, polish_iters;
  double eps, tol;
  const void *verts, *faces, *c1, *c2;
  const void* poses[4];
  long long strides[8];
  void *out, *state, *stream;
};

template <typename T, int K1, int K2, bool MULTI>
int launch_kernel(const Args& A, int threads, int cs) {
  auto kernel = fw_search_kernel<T, K1, K2, MULTI>;
  const size_t bytes = smem_bytes<T>();
  if (cs > 8) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  Poses<T> P{(const T*)A.poses[0], (const T*)A.poses[1], (const T*)A.poses[2], (const T*)A.poses[3], {}};
  for (int i = 0; i < 8; ++i) P.s[i] = A.strides[i];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(A.R * cs), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)A.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, A.F, A.iters, A.polish_iters, (T)A.eps, (T)A.tol,
                                       (const T*)A.verts, (const int64_t*)A.faces, P, (const T*)A.c1,
                                       (const T*)A.c2, out_views<T>(A.out, A.R, A.F), (T*)A.state);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int K1, int K2>
int launch_kinds(const Args& A) {
  int threads, cs;
  geometry(A.R, A.F, threads, cs);
  return A.F > FACE_CAP ? launch_kernel<T, K1, K2, true>(A, threads, cs)
                        : launch_kernel<T, K1, K2, false>(A, threads, cs);
}

template <typename T, int K1, int K2, bool MULTI>
int resources_kernel(int threads, int cs, long long* out) {
  auto kernel = fw_search_kernel<T, K1, K2, MULTI>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem_bytes<T>());
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = cs;
  out[2] = (long long)smem_bytes<T>();
  out[3] = attr.numRegs;
  out[4] = (long long)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

template <typename T, int K1, int K2>
int resources_kinds(const Args& A, long long* out) {
  int threads, cs;
  geometry(A.R, A.F, threads, cs);
  return A.F > FACE_CAP ? resources_kernel<T, K1, K2, true>(threads, cs, out)
                        : resources_kernel<T, K1, K2, false>(threads, cs, out);
}

// run op<T, K1, K2>(args...) for the runtime kinds
template <typename T, template <typename, int, int> class Op, class... X>
int dispatch(int kind1, int kind2, X... x) {
#define FW_K2(K1v, K2v) \
  case K2v:             \
    return Op<T, K1v, K2v>::run(x...);
#define FW_K1(K1v)                    \
  case K1v:                           \
    switch (kind2) {                  \
      FW_K2(K1v, KIND_SPHERE)         \
      FW_K2(K1v, KIND_BOX)            \
      FW_K2(K1v, KIND_ROUNDED_BOX)    \
      FW_K2(K1v, KIND_CYLINDER)       \
      FW_K2(K1v, KIND_BRICK)          \
    }                                 \
    return (int)cudaErrorInvalidValue;
  switch (kind1) {
    FW_K1(KIND_NONE)
    FW_K1(KIND_SPHERE)
    FW_K1(KIND_BOX)
    FW_K1(KIND_ROUNDED_BOX)
    FW_K1(KIND_CYLINDER)
    FW_K1(KIND_BRICK)
  }
#undef FW_K1
#undef FW_K2
  return (int)cudaErrorInvalidValue;
}

template <typename T, int K1, int K2>
struct Launch {
  static int run(const Args& A) { return launch_kinds<T, K1, K2>(A); }
};
template <typename T, int K1, int K2>
struct Resources {
  static int run(const Args& A, long long* out) { return resources_kinds<T, K1, K2>(A, out); }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64; kind1 = -1 when body 1 is a plain mesh
// (c1 unused). verts (V, 3) and faces (F, 3) int64 are contiguous; poses:
// q1 (R, 4), pos1 (R, 3), q2 (R, 4), pos2 (R, 3) with strides (row,
// component) in elements, 8 values in that order; c1, c2: NBODY constants
// per body (scale, kind parameters). out: see out_views. state: scratch of
// NSTATE R F values when F > FACE_CAP (unused, may be null, below). Returns
// the launch's CUDA error; cudaErrorInvalidValue for F < 1 or a missing
// state.
int fw_search(int dtype, int kind1, int kind2, int R, int F, int iters, int polish_iters, double eps, double tol,
              const void* verts, const void* faces, const void* q1, const void* pos1, const void* q2,
              const void* pos2, const long long* strides, const void* c1, const void* c2, void* out, void* state,
              void* stream) {
  if (F < 1 || (F > FACE_CAP && !state)) return (int)cudaErrorInvalidValue;
  if (R < 1) return 0;
  Args A{R, F, iters, polish_iters, eps, tol, verts, faces, c1, c2, {q1, pos1, q2, pos2}, {}, out, state, stream};
  for (int i = 0; i < 8; ++i) A.strides[i] = strides[i];
  return dtype == 1 ? dispatch<double, Launch>(kind1, kind2, A) : dispatch<float, Launch>(kind1, kind2, A);
}

// the launch's resources at R poses of F faces: threads per CTA, CTAs per
// pose (cluster), shared bytes per CTA, registers and local (spill) bytes
// per thread, CTAs per SM
int fw_search_info(int dtype, int kind1, int kind2, int R, int F, long long* out) {
  if (F < 1) return (int)cudaErrorInvalidValue;
  Args A{R, F, 0, 0, 0.0, 0.0, nullptr, nullptr, nullptr, nullptr, {}, {}, nullptr, nullptr, nullptr};
  return dtype == 1 ? dispatch<double, Resources>(kind1, kind2, A, out)
                    : dispatch<float, Resources>(kind1, kind2, A, out);
}

}  // extern "C"
