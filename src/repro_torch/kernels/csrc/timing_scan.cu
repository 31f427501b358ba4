// Batched schedule-IR timing recurrence, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/timing_scan.py::_kernel, the Pallas
// blocked-scan kernel of the reference package, and computes exactly what
// it and the reference's numpy recurrence (_timing_numpy in
// src/repro/core/ir/backends.py) compute, in the same per-step order:
//
//   1. bypass relay hops (store-and-forward on installed configs);
//   2. the lazy +t_recfg on planes whose config changes;
//   3. start = chain ? max(barrier, free) : free, end = start + vol / bw;
//   4. the barrier / CCT max;
//   5. the feasibility and volume-conservation flags;
//   6. with attribution, the four (B, S, P) component cubes: direct
//      transmission, bypass carry, exposed reconfiguration wait, hidden
//      reconfiguration.
//
// Design.  One thread owns one batch row (one sweep cell) and carries its
// planes' free time, held config and busy time through the step loop in
// thread-local arrays, templated on a maximum plane count (8/16/32/64/128).
// The TPU kernel's one-hot masked-max plane gathers and its (blk, S, P)
// VMEM block exist for TPU lowering only; here a hop's plane is a plain
// indexed load, and each thread reads its own row of the packed arrays.
// Routes and hops loop at run time; the packed arrays are taken as the
// host packs them (int64 ids, uint8 bools), unpadded: the thread loops over
// the batch's S and P and masks ragged edges itself.
//
// Bitwise contract.  Built with -fmad=false, so no a*b+c is contracted;
// no atomics (each thread writes only its own row); max follows numpy's
// maximum for non-NaN inputs.  The conservation sum "sent" adds planes in
// plane order; it only feeds a tolerance test, and the plain torch version
// adds in the same order.
//
// What bounds it on an H100.  Not the bytes: the main path's (1024, 127, 8)
// float64 volume cube is 8.3 MB, about 2.5 us of reads at 3.35 TB/s.  It is
// the sequential dependency chain -- 127 steps x 8 planes of dependent fp64
// divides and maxes in each thread -- with only 1024 threads on 132 SMs.
// This first version is simple and right; making it fast (planes across
// lanes, steps prefetched, more rows in flight) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kEpsVolume = 1e-6;  // repro_torch.core.tolerances.EPS_VOLUME
constexpr double kTol = 1e-9;        // TOL
constexpr double kRelTol = 1e-6;     // REL_TOL

// numpy's maximum for non-NaN inputs: the first argument wins ties.
__device__ __forceinline__ double np_max(double a, double b) {
  return a >= b ? a : b;
}

struct Args {
  const double* vol;          // (B, S, P)
  const double* step_vol;     // (B, S)
  const int64_t* step_cfg;    // (B, S)
  const uint8_t* step_mask;   // (B, S)
  const uint8_t* plane_mask;  // (B, P)
  const double* bw;           // (B, P)
  const int64_t* init;        // (B, P)
  const double* t_recfg;      // (B,)
  const uint8_t* chain;       // (B,)
  const double* ready;        // (B, P)
  const double* byp_vol;      // (B, S, R)
  const int64_t* byp_plane;   // (B, S, R, H); -1 = no hop
  double* cct;                // (B,)
  int64_t* n_recfg;           // (B,)
  double* busy;               // (B, P)
  uint8_t* feasible;          // (B,)
  uint8_t* volume_ok;         // (B,)
  double* att_xmit;           // (B, S, P) or null
  double* att_byp;            // (B, S, P) or null
  double* att_wait;           // (B, S, P) or null
  double* att_hidden;         // (B, S, P) or null
  int64_t B, S, P, R, H;
};

template <int MAXP>
__global__ void timing_scan_kernel(const Args a) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int64_t S = a.S, P = a.P, R = a.R, H = a.H;
  const bool attribution = a.att_xmit != nullptr;

  double free_t[MAXP], busy_t[MAXP], bw[MAXP];
  int64_t held[MAXP];
  bool real[MAXP];
  for (int p = 0; p < P; ++p) {
    free_t[p] = a.ready[b * P + p];
    held[p] = a.init[b * P + p];
    bw[p] = a.bw[b * P + p];
    real[p] = a.plane_mask[b * P + p] != 0;
    busy_t[p] = 0.0;
  }
  const double t_recfg = a.t_recfg[b];
  const bool chain = a.chain[b] != 0;
  double barrier = 0.0, cct = 0.0;
  int64_t n_recfg = 0;
  bool feasible = true, volume_ok = true;

  for (int64_t i = 0; i < S; ++i) {
    const int64_t bs = b * S + i;
    const bool live = a.step_mask[bs] != 0;
    const double svol = a.step_vol[bs];
    const int64_t scfg = a.step_cfg[bs];
    const double* v = a.vol + bs * P;
    if (attribution) {
      for (int p = 0; p < P; ++p) a.att_byp[bs * P + p] = 0.0;
    }

    // 1. Bypass relays first: they ride installed configs, before this
    //    step's direct traffic forces reconfigurations.
    double byp_end = -INFINITY, sent_byp = 0.0;
    bool has_byp = false;
    for (int64_t r = 0; r < R; ++r) {
      const double rv = a.byp_vol[bs * R + r];
      if (!(rv > kEpsVolume && live)) continue;
      has_byp = true;
      sent_byp = sent_byp + rv;
      double prev_end = chain ? barrier : 0.0;
      const int64_t* hops = a.byp_plane + (bs * R + r) * H;
      for (int64_t h = 0; h < H; ++h) {
        const int64_t j = hops[h];
        if (j < 0) continue;
        const int64_t jj = j < P - 1 ? j : P - 1;
        const double start = np_max(prev_end, free_t[jj]);
        const double end = start + rv / bw[jj];
        free_t[jj] = end;
        busy_t[jj] = busy_t[jj] + (end - start);
        if (attribution) {
          a.att_byp[bs * P + jj] = a.att_byp[bs * P + jj] + (end - start);
        }
        prev_end = end;
      }
      byp_end = np_max(byp_end, prev_end);
    }

    // 5. Feasibility and volume conservation (routes deliver once).
    bool has = false;
    double sent = 0.0;
    for (int p = 0; p < P; ++p) {
      const bool active = v[p] > kEpsVolume && real[p] && live;
      has = has || active;
      sent = sent + (active ? v[p] : 0.0);
    }
    sent = sent + sent_byp;
    feasible = feasible && !(live && svol > kEpsVolume && !has && !has_byp);
    const double cons_tol = np_max(kTol, kRelTol * np_max(svol, 1.0));
    volume_ok = volume_ok && (!live || fabs(sent - svol) <= cons_tol);

    // 2-4. Lazy reconfiguration, then direct transmissions.
    double step_end = -INFINITY;
    for (int p = 0; p < P; ++p) {
      const bool active = v[p] > kEpsVolume && real[p] && live;
      const bool need = active && held[p] != scfg;
      const double free_before = free_t[p];
      double free_p = free_before;
      if (need) {
        free_p = free_p + t_recfg;
        held[p] = scfg;
        busy_t[p] = busy_t[p] + t_recfg;
        ++n_recfg;
      }
      const double start = chain ? np_max(barrier, free_p) : free_p;
      const double end = start + v[p] / bw[p];
      if (attribution) {
        const double start_nr =
            chain ? np_max(barrier, free_before) : free_before;
        const double wait = need ? start - start_nr : 0.0;
        a.att_wait[bs * P + p] = wait;
        a.att_hidden[bs * P + p] = need ? t_recfg - wait : 0.0;
        a.att_xmit[bs * P + p] = active ? end - start : 0.0;
      }
      if (active) {
        free_p = end;
        busy_t[p] = busy_t[p] + (end - start);
        step_end = np_max(step_end, end);
      }
      free_t[p] = free_p;
    }
    step_end = np_max(step_end, byp_end);
    if (has || has_byp) {
      barrier = np_max(barrier, step_end);
      cct = np_max(cct, step_end);
    }
  }

  a.cct[b] = cct;
  a.n_recfg[b] = n_recfg;
  for (int p = 0; p < P; ++p) a.busy[b * P + p] = busy_t[p];
  a.feasible[b] = feasible ? 1 : 0;
  a.volume_ok[b] = volume_ok ? 1 : 0;
}

}  // namespace

// Plain C entry, bound with ctypes.  Launches on ``stream`` (PyTorch's
// current stream) on device ``device``, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).  The att_*
// pointers are all null (attribution off) or all set.
extern "C" int timing_scan_launch(
    const void* vol, const void* step_vol, const void* step_cfg,
    const void* step_mask, const void* plane_mask, const void* bw,
    const void* init, const void* t_recfg, const void* chain,
    const void* ready, const void* byp_vol, const void* byp_plane,
    void* cct, void* n_recfg, void* busy, void* feasible, void* volume_ok,
    void* att_xmit, void* att_byp, void* att_wait, void* att_hidden,
    int64_t B, int64_t S, int64_t P, int64_t R, int64_t H, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{
      static_cast<const double*>(vol), static_cast<const double*>(step_vol),
      static_cast<const int64_t*>(step_cfg),
      static_cast<const uint8_t*>(step_mask),
      static_cast<const uint8_t*>(plane_mask), static_cast<const double*>(bw),
      static_cast<const int64_t*>(init), static_cast<const double*>(t_recfg),
      static_cast<const uint8_t*>(chain), static_cast<const double*>(ready),
      static_cast<const double*>(byp_vol),
      static_cast<const int64_t*>(byp_plane), static_cast<double*>(cct),
      static_cast<int64_t*>(n_recfg), static_cast<double*>(busy),
      static_cast<uint8_t*>(feasible), static_cast<uint8_t*>(volume_ok),
      static_cast<double*>(att_xmit), static_cast<double*>(att_byp),
      static_cast<double*>(att_wait), static_cast<double*>(att_hidden),
      B, S, P, R, H};
  // Small blocks spread the few rows of a sweep over many SMs.
  constexpr int kThreads = 32;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 8) {
    timing_scan_kernel<8><<<blocks, kThreads, 0, st>>>(a);
  } else if (P <= 16) {
    timing_scan_kernel<16><<<blocks, kThreads, 0, st>>>(a);
  } else if (P <= 32) {
    timing_scan_kernel<32><<<blocks, kThreads, 0, st>>>(a);
  } else if (P <= 64) {
    timing_scan_kernel<64><<<blocks, kThreads, 0, st>>>(a);
  } else if (P <= 128) {
    timing_scan_kernel<128><<<blocks, kThreads, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
