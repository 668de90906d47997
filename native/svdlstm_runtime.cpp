// svdlstm_runtime — dependency-free C++17 streaming inference engine.
//
// The reference exports per-gate CSV weights for a LabVIEW real-time
// consumer (reference code/load_preprocess.py:93-126); this is that
// consumer, rebuilt: it loads the CSV export directory and runs
// state-carrying batch-1 inference, either with dense cells (the v1 NumPy
// semantics, reference code/old_versions/svd_classes.py:25-42) or with the
// exact two-step reduced cells (reference :45-101: wix[:r] = B·x;
// wix[r:] = C·wix[:r]).
//
// Exposed as a C ABI for ctypes (svd_lstm_tpu/io/native.py). Single file,
// no dependencies beyond the C++ standard library.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

using Mat = std::vector<std::vector<float>>;  // row-major [rows][cols]

bool load_csv(const std::string& path, Mat* out) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return false;
  out->clear();
  // Accumulate whole physical lines — fgets returns 64 KB chunks, and a
  // row longer than the buffer (wide matrices at %.18e ≈ 25 B/value) must
  // not be split into two ragged rows (FlatMat assumes uniform widths).
  char buf[1 << 16];
  std::string line;
  bool ragged = false;
  auto flush_line = [&]() {
    std::vector<float> row;
    const char* p = line.c_str();
    while (*p) {
      char* end = nullptr;
      float v = std::strtof(p, &end);
      if (end == p) break;
      row.push_back(v);
      p = end;
      while (*p == ',' || *p == ' ' || *p == '\n' || *p == '\r') ++p;
    }
    if (!row.empty()) {
      if (!out->empty() && row.size() != (*out)[0].size()) ragged = true;
      out->push_back(std::move(row));
    }
    line.clear();
  };
  while (std::fgets(buf, sizeof(buf), f)) {
    line += buf;
    if (!line.empty() && line.back() == '\n') flush_line();
  }
  if (!line.empty()) flush_line();
  std::fclose(f);
  // Ragged rows (hand-edited/truncated files) would make FlatMat::from
  // read past the shorter rows' allocations — reject the whole file.
  return !out->empty() && !ragged;
}

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

// Flat row-major matrix: contiguous storage so the inner GEMV loop
// auto-vectorizes and prefetches (vector-of-vectors measured ~1.6x slower
// from pointer chasing; the step loop is allocation-free — the reference's
// own real-time cells preallocated their buffers, old_versions/
// svd_classes.py:56-68).
struct FlatMat {
  int rows = 0, cols = 0;
  std::vector<float> d;  // rows*cols
  void from(const Mat& m) {
    rows = static_cast<int>(m.size());
    cols = rows ? static_cast<int>(m[0].size()) : 0;
    d.resize(static_cast<size_t>(rows) * cols);
    for (int i = 0; i < rows; ++i)
      std::memcpy(&d[static_cast<size_t>(i) * cols], m[i].data(),
                  sizeof(float) * cols);
  }
  bool empty() const { return rows == 0 || cols == 0; }
};

// y += M^T x  with M stored flat (in_dim x out_dim): y[j] += x[i]*M[i][j]
void accum_xTM(const float* x, const FlatMat& M, float* __restrict y) {
  for (int i = 0; i < M.rows; ++i) {
    const float xi = x[i];
    const float* __restrict mrow = &M.d[static_cast<size_t>(i) * M.cols];
    for (int j = 0; j < M.cols; ++j) y[j] += xi * mrow[j];
  }
}

// y[j] += dot(x, Mt[j]) with Mt stored flat (out_dim x in_dim) — the
// transposed/dot form. For short out_dim (the tiny per-gate C factors)
// this keeps every inner loop running over the long contraction dim,
// where the accumulate form would scatter into a <8-lane-wide output.
void accum_dot(const float* x, const FlatMat& Mt, float* __restrict y) {
  for (int j = 0; j < Mt.rows; ++j) {
    const float* __restrict mrow = &Mt.d[static_cast<size_t>(j) * Mt.cols];
    float acc = 0.0f;
    for (int i = 0; i < Mt.cols; ++i) acc += x[i] * mrow[i];
    y[j] += acc;
  }
}

FlatMat transpose(const FlatMat& M) {
  FlatMat T;
  T.rows = M.cols;
  T.cols = M.rows;
  T.d.resize(M.d.size());
  for (int i = 0; i < M.rows; ++i)
    for (int j = 0; j < M.cols; ++j)
      T.d[static_cast<size_t>(j) * T.cols + i] =
          M.d[static_cast<size_t>(i) * M.cols + j];
  return T;
}

struct GatePair {        // two-step factors for one gate: z = [vB, (vB)C]
  FlatMat B;             // (in_dim, r)
  FlatMat C;             // (r, n - r)  (may have 0 cols when r == n)
};

struct Layer {
  // Per-SIDE execution dispatch: a reduced export whose rank can't pay
  // for the two-step's irregular small GEMVs is reconstructed to dense AT
  // LOAD (the rule of ops/layouts.py: store compressed, execute dense
  // when the two-step loses). Measured crossover on the host CPU
  // (scripts/bench_native.py): r/n = 0.4 wins (0.92x), 0.5 loses (1.18x).
  bool w_reduced = false, u_reduced = false;
  // group count per side: 4 = split (per-gate factors), 1 = merged (one
  // SVD of the whole (rows x 4n) matrix — its two-step spans all four
  // gates' pre-activations at once, reference svd_classes_v3.py:249-279)
  int w_groups = 4, u_groups = 4;
  // dense: all four gates concatenated column-wise — ONE GEMV per side
  // with a 4n-wide inner loop instead of four n-wide ones (vectorizes and
  // amortizes the row loop).
  FlatMat Wcat, Ucat;            // (in_dim x 4n), (n x 4n)
  // reduced: packed-B (all groups' B side by side) + per-group C
  FlatMat wBcat, uBcat;          // (in_dim x sum r_g), (n x sum r_g)
  FlatMat wC[4], uC[4];          // (r_g x gw-r_g), or transposed (dot form)
  bool wCdot[4] = {}, uCdot[4] = {};  // true -> C stored transposed
  int wOff[4] = {0, 0, 0, 0}, uOff[4] = {0, 0, 0, 0};  // col offset of group g in *Bcat
  std::vector<float> bcat;       // (4n)
  int units = 0;
  std::vector<float> h, c;       // state
  std::vector<float> zg, zs;     // scratch: 4n gate pre-acts, packed-B temp
};

// column-concatenate gate matrices (equal rows) into one FlatMat
FlatMat cat_cols(const FlatMat* ms, int count, int* offs) {
  FlatMat out;
  out.rows = ms[0].rows;
  out.cols = 0;
  for (int g = 0; g < count; ++g) {
    offs[g] = out.cols;
    out.cols += ms[g].cols;
  }
  out.d.assign(static_cast<size_t>(out.rows) * out.cols, 0.0f);
  for (int g = 0; g < count; ++g)
    for (int i = 0; i < out.rows; ++i)
      std::memcpy(&out.d[static_cast<size_t>(i) * out.cols + offs[g]],
                  &ms[g].d[static_cast<size_t>(i) * ms[g].cols],
                  sizeof(float) * ms[g].cols);
  return out;
}

// Causal-conv front end of the conv hybrids (models/conv.py): a shift
// buffer of the last k frames (zero-init = the whole-sequence path's
// causal left padding) and ONE flat GEMV over the (k*c_in x filters)
// tap-major kernel per frame, then relu.
struct ConvFront {
  int k = 0, c_in = 0, filters = 0;
  FlatMat w;               // (k*c_in) x filters, row i = tap*c_in + channel
  std::vector<float> b;    // (filters)
  std::vector<float> buf;  // (k*c_in) shift buffer, oldest frame first
  std::vector<float> out;  // (filters) scratch
  bool present() const { return filters > 0; }
};

void conv_step(ConvFront& C, const float* frame) {
  const int span = C.k * C.c_in;
  std::memmove(C.buf.data(), C.buf.data() + C.c_in,
               sizeof(float) * (span - C.c_in));
  std::memcpy(C.buf.data() + span - C.c_in, frame, sizeof(float) * C.c_in);
  for (int j = 0; j < C.filters; ++j) C.out[j] = C.b[j];
  accum_xTM(C.buf.data(), C.w, C.out.data());
  for (int j = 0; j < C.filters; ++j)
    C.out[j] = C.out[j] > 0.0f ? C.out[j] : 0.0f;
}

// conv/ export directory: w.csv (k*c_in x filters), b.csv (filters),
// shape.csv (one row: k, c_in) — io/csv_weights.py conv export.
bool load_conv(const std::string& dir, ConvFront* C) {
  Mat w, b, shape;
  if (!load_csv(dir + "/w.csv", &w)) return false;
  if (!load_csv(dir + "/b.csv", &b)) return false;
  if (!load_csv(dir + "/shape.csv", &shape) || shape[0].size() < 2)
    return false;
  const int k = static_cast<int>(shape[0][0]);
  const int c_in = static_cast<int>(shape[0][1]);
  if (k <= 0 || c_in <= 0) return false;
  C->w.from(w);
  if (C->w.rows != k * c_in) return false;
  C->k = k;
  C->c_in = c_in;
  C->filters = C->w.cols;
  for (auto& row : b)
    for (float v : row) C->b.push_back(v);
  if (static_cast<int>(C->b.size()) != C->filters) return false;
  C->buf.assign(static_cast<size_t>(k) * c_in, 0.0f);
  C->out.assign(C->filters, 0.0f);
  return true;
}

struct Model {
  ConvFront conv;             // optional causal-conv front end
  std::vector<Layer> layers;
  std::vector<float> head_w;  // (n)
  float head_b = 0.0f;
};

// Does the exact two-step pay for this side's ranks? FLOP-aware rule:
// per group the two-step costs r·(m + gw − r) MACs vs m·gw dense
// (slide-9 accounting), and the measured crossover on this runtime
// (scripts/bench_native.py, host CPU, 4x40/4x30: r/n = 0.4 steps at 0.92x, 0.5 at
// 1.18x, 0.625 at 1.41x on the square U side) puts the overhead of the
// irregular small GEMVs at ~30% of dense — keep the factored path only
// when it saves at least that. Unlike the earlier rank-ratio rule
// (sum r/(4n) < 0.45), this accounts for the input width m: a W side
// with m ≪ n (e.g. the 16-wide DROPBEAR frames into 40 units) is already
// cheap dense, and its full-rank "reduction" (r = m) saves zero FLOPs —
// measured 1.12x at 4x40 r=25 under the old rule, 1.0 dispatched here.
// groups: 4 split (group width n) / 1 merged (one group spanning 4n).
bool two_step_pays(const FlatMat* B, int groups, int n) {
  const int gw = (groups == 1) ? 4 * n : n;
  long two = 0, dense = 0;
  for (int g = 0; g < groups; ++g) {
    const long r = B[g].cols, m = B[g].rows;
    two += r * (m + gw - r);
    dense += m * static_cast<long>(gw);
  }
  return two * 10 < dense * 7;  // two-step < 70% of dense MACs
}

// Dense gate matrix from the two-step factors: D = [B | B·C] (rows x n),
// exactly the matrix the factors reconstruct (reference two-step
// semantics, old_versions/svd_classes.py:45-101). C may be stored
// transposed (dot form).
FlatMat densify_gate(const FlatMat& B, const FlatMat& C, bool Cdot, int n) {
  FlatMat D;
  D.rows = B.rows;
  D.cols = n;
  D.d.assign(static_cast<size_t>(D.rows) * n, 0.0f);
  const int r = B.cols;
  const int m = n - r;
  for (int i = 0; i < D.rows; ++i) {
    const float* brow = &B.d[static_cast<size_t>(i) * r];
    float* drow = &D.d[static_cast<size_t>(i) * n];
    std::memcpy(drow, brow, sizeof(float) * r);
    if (C.empty() || m <= 0) continue;
    if (Cdot) {  // C stored (m x r): column j of effective C is row j
      for (int j = 0; j < m; ++j) {
        const float* crow = &C.d[static_cast<size_t>(j) * r];
        float acc = 0.0f;
        for (int k = 0; k < r; ++k) acc += brow[k] * crow[k];
        drow[r + j] = acc;
      }
    } else {  // C stored (r x m)
      for (int k = 0; k < r; ++k) {
        const float bik = brow[k];
        const float* crow = &C.d[static_cast<size_t>(k) * m];
        for (int j = 0; j < m; ++j) drow[r + j] += bik * crow[j];
      }
    }
  }
  return D;
}

// Finalize a reduced layer's two sides: pack the factored form where the
// two-step pays (or is forced), reconstruct to a dense cat where it
// can't — so a consumer loading a shallow-rank export never steps slower
// than dense (the layout rule of ops/layouts.py, mirrored).
// groups: 4 = split (per-gate width n), 1 = merged (one group, width 4n).
void finalize_reduced_sides(Layer* L, FlatMat* wB, FlatMat* uB,
                            bool force_two_step, int groups) {
  // units from the recurrent side's row count (uB rows = n in both forms)
  const int n = uB[0].rows;
  const int gw = (groups == 1) ? 4 * n : n;  // per-group output width
  L->units = n;
  L->w_groups = L->u_groups = groups;
  L->w_reduced = force_two_step || two_step_pays(wB, groups, n);
  L->u_reduced = force_two_step || two_step_pays(uB, groups, n);
  int offs[4];
  if (L->w_reduced) {
    L->wBcat = cat_cols(wB, groups, L->wOff);
  } else {
    FlatMat Dg[4];
    for (int g = 0; g < groups; ++g)
      Dg[g] = densify_gate(wB[g], L->wC[g], L->wCdot[g], gw);
    L->Wcat = cat_cols(Dg, groups, offs);
    for (int g = 0; g < groups; ++g) L->wC[g] = FlatMat();
  }
  if (L->u_reduced) {
    L->uBcat = cat_cols(uB, groups, L->uOff);
  } else {
    FlatMat Dg[4];
    for (int g = 0; g < groups; ++g)
      Dg[g] = densify_gate(uB[g], L->uC[g], L->uCdot[g], gw);
    L->Ucat = cat_cols(Dg, groups, offs);
    for (int g = 0; g < groups; ++g) L->uC[g] = FlatMat();
  }
}

const char* kGates = "ifco";

bool load_dense_layer(const std::string& dir, Layer* L, bool transposed) {
  FlatMat Wg[4], Ug[4];
  std::vector<float> bs;
  for (int g = 0; g < 4; ++g) {
    Mat W, U, b;
    std::string gs(1, kGates[g]);
    if (!load_csv(dir + "/W" + gs + ".csv", &W)) return false;
    if (!load_csv(dir + "/U" + gs + ".csv", &U)) return false;
    if (!load_csv(dir + "/b" + gs + ".csv", &b)) return false;
    if (transposed) {  // files store (n x in_dim); we want (in_dim x n)
      Mat Wt(W[0].size(), std::vector<float>(W.size()));
      for (size_t i = 0; i < W.size(); ++i)
        for (size_t j = 0; j < W[0].size(); ++j) Wt[j][i] = W[i][j];
      Mat Ut(U[0].size(), std::vector<float>(U.size()));
      for (size_t i = 0; i < U.size(); ++i)
        for (size_t j = 0; j < U[0].size(); ++j) Ut[j][i] = U[i][j];
      W.swap(Wt);
      U.swap(Ut);
    }
    Wg[g].from(W);
    Ug[g].from(U);
    for (auto& row : b)
      for (float v : row) bs.push_back(v);
  }
  int offs[4];
  L->Wcat = cat_cols(Wg, 4, offs);
  L->Ucat = cat_cols(Ug, 4, offs);
  L->bcat = std::move(bs);
  L->units = L->Ucat.rows;  // U is (n x n)
  L->w_reduced = L->u_reduced = false;
  return true;
}

bool load_reduced_layer(const std::string& dir, Layer* L, bool force_two_step) {
  FlatMat wB[4], uB[4];
  std::vector<float> bs;
  for (int g = 0; g < 4; ++g) {
    std::string gs(1, kGates[g]);
    Mat B;
    if (!load_csv(dir + "/wB" + gs + ".csv", &B)) return false;
    wB[g].from(B);
    B.clear();
    if (!load_csv(dir + "/uB" + gs + ".csv", &B)) return false;
    uB[g].from(B);
    // C may be absent (full rank) — treat as 0-column
    Mat C;
    // Pick the GEMV form with the longer inner loop: accumulate iterates
    // the output dim (n-r), dot the contraction dim (r); store C
    // transposed when dot wins (r > n-r).
    FlatMat Ctmp;
    if (load_csv(dir + "/wC" + gs + ".csv", &C)) {
      Ctmp.from(C);
      L->wCdot[g] = Ctmp.rows > Ctmp.cols;
      L->wC[g] = L->wCdot[g] ? transpose(Ctmp) : Ctmp;
    } else L->wC[g] = FlatMat();
    C.clear();
    if (load_csv(dir + "/uC" + gs + ".csv", &C)) {
      Ctmp.from(C);
      L->uCdot[g] = Ctmp.rows > Ctmp.cols;
      L->uC[g] = L->uCdot[g] ? transpose(Ctmp) : Ctmp;
    } else L->uC[g] = FlatMat();
    Mat b;
    if (!load_csv(dir + "/b" + gs + ".csv", &b)) return false;
    for (auto& row : b)
      for (float v : row) bs.push_back(v);
  }
  L->bcat = std::move(bs);
  finalize_reduced_sides(L, wB, uB, force_two_step, 4);
  return true;
}

// merged-kernel reduced layer: one SVD of the whole (rows x 4n) matrix per
// side (reference svd_classes_v3.py:249-279) — files wB/wC/uB/uC/b.csv
// (no gate suffix; io/native.py save_reduced_weights_as_csv merged form).
bool load_merged_layer(const std::string& dir, Layer* L, bool force_two_step) {
  FlatMat wB[1], uB[1];
  Mat m;
  if (!load_csv(dir + "/wB.csv", &m)) return false;
  wB[0].from(m);
  m.clear();
  if (!load_csv(dir + "/uB.csv", &m)) return false;
  uB[0].from(m);
  FlatMat Ctmp;
  m.clear();
  if (load_csv(dir + "/wC.csv", &m)) {  // absent at full rank
    Ctmp.from(m);
    L->wCdot[0] = Ctmp.rows > Ctmp.cols;
    L->wC[0] = L->wCdot[0] ? transpose(Ctmp) : Ctmp;
  } else L->wC[0] = FlatMat();
  m.clear();
  if (load_csv(dir + "/uC.csv", &m)) {
    Ctmp.from(m);
    L->uCdot[0] = Ctmp.rows > Ctmp.cols;
    L->uC[0] = L->uCdot[0] ? transpose(Ctmp) : Ctmp;
  } else L->uC[0] = FlatMat();
  Mat b;
  if (!load_csv(dir + "/b.csv", &b)) return false;
  std::vector<float> bs;
  for (auto& row : b)
    for (float v : row) bs.push_back(v);
  L->bcat = std::move(bs);
  finalize_reduced_sides(L, wB, uB, force_two_step, 1);
  return true;
}

// packed two-step side: tmp = v·Bcat (ONE wide GEMV for all groups), then
// per group g: z_g[0..r) += tmp_g, z_g[r..gw) += tmp_g·C_g. groups = 4
// split (group width n) or 1 merged (one group spanning all 4n gate
// columns). The step loop allocates nothing.
void two_step_side(Layer& L, const float* v, const FlatMat& Bcat,
                   const int* off, const FlatMat* C, const bool* Cdot,
                   float* __restrict zg, int groups) {
  const int gw = (groups == 1) ? 4 * L.units : L.units;
  float* tmp = L.zs.data();
  for (int j = 0; j < Bcat.cols; ++j) tmp[j] = 0.0f;
  accum_xTM(v, Bcat, tmp);
  for (int g = 0; g < groups; ++g) {
    const int r = (g + 1 < groups ? off[g + 1] : Bcat.cols) - off[g];
    float* z = zg + g * gw;
    const float* tg = tmp + off[g];
    for (int j = 0; j < r; ++j) z[j] += tg[j];
    if (C[g].empty()) continue;
    if (Cdot[g]) accum_dot(tg, C[g], z + r);
    else accum_xTM(tg, C[g], z + r);
  }
}

void layer_step(Layer& L, const float* x) {
  const int n = L.units;
  float* zg = L.zg.data();
  std::memcpy(zg, L.bcat.data(), sizeof(float) * 4 * n);
  if (L.w_reduced)
    two_step_side(L, x, L.wBcat, L.wOff, L.wC, L.wCdot, zg, L.w_groups);
  else accum_xTM(x, L.Wcat, zg);
  if (L.u_reduced)
    two_step_side(L, L.h.data(), L.uBcat, L.uOff, L.uC, L.uCdot, zg, L.u_groups);
  else accum_xTM(L.h.data(), L.Ucat, zg);
  for (int j = 0; j < n; ++j) {
    const float i = sigmoidf(zg[0 * n + j]);
    const float f = sigmoidf(zg[1 * n + j]);
    const float gg = std::tanh(zg[2 * n + j]);
    const float o = sigmoidf(zg[3 * n + j]);
    L.c[j] = f * L.c[j] + i * gg;
    L.h[j] = o * std::tanh(L.c[j]);
  }
}


// ---------------------------------------------------------------------------
// int8 binary artifact (io/int8_export.py): "SVDL8BIN", per-output-column
// symmetric quantization (w ~= q * scale). Dequantized on load — the
// streaming math stays f32; the artifact is ~4x smaller than f32 CSVs.
// ---------------------------------------------------------------------------

bool read_exact(FILE* f, void* dst, size_t n) {
  return std::fread(dst, 1, n, f) == n;
}

bool read_u32(FILE* f, uint32_t* v) { return read_exact(f, v, 4); }

// qmat: u32 rows, u32 cols, f32 scale[cols], i8 data[rows*cols]
bool read_qmat(FILE* f, FlatMat* out) {
  uint32_t rows = 0, cols = 0;
  if (!read_u32(f, &rows) || !read_u32(f, &cols)) return false;
  out->rows = static_cast<int>(rows);
  out->cols = static_cast<int>(cols);
  out->d.assign(static_cast<size_t>(rows) * cols, 0.0f);
  if (cols == 0) return true;
  std::vector<float> scale(cols);
  if (!read_exact(f, scale.data(), sizeof(float) * cols)) return false;
  std::vector<int8_t> q(static_cast<size_t>(rows) * cols);
  if (rows && !read_exact(f, q.data(), q.size())) return false;
  for (uint32_t i = 0; i < rows; ++i)
    for (uint32_t j = 0; j < cols; ++j)
      out->d[static_cast<size_t>(i) * cols + j] =
          static_cast<float>(q[static_cast<size_t>(i) * cols + j]) * scale[j];
  return true;
}

bool read_fvec(FILE* f, std::vector<float>* out) {
  uint32_t len = 0;
  if (!read_u32(f, &len)) return false;
  out->assign(len, 0.0f);
  return len == 0 || read_exact(f, out->data(), sizeof(float) * len);
}

// choose accumulate vs dot form for a loaded C factor (same heuristic as
// load_reduced_layer: dot iterates the contraction dim — wins when r > n-r)
void place_C(FlatMat&& C, FlatMat* slot, bool* dot) {
  *dot = C.rows > C.cols;
  *slot = *dot ? transpose(C) : std::move(C);
}

bool load_int8_model(const std::string& path, Model* m,
                     bool force_two_step) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[8];
  uint32_t version = 0, n_layers = 0;
  // version 1: kinds 'd'/'r'. version 2 adds 'm' (merged-kernel reduced).
  // version 3 adds an optional causal-conv front-end section (conv
  // hybrids). All remain readable.
  bool ok = read_exact(f, magic, 8) && std::memcmp(magic, "SVDL8BIN", 8) == 0 &&
            read_u32(f, &version) && (version >= 1 && version <= 3) &&
            read_u32(f, &n_layers);
  if (ok && version >= 3) {
    uint8_t has_conv = 0;
    ok = read_exact(f, &has_conv, 1);
    if (ok && has_conv) {
      uint32_t k = 0, c_in = 0;
      ok = read_u32(f, &k) && read_u32(f, &c_in) && k > 0 && c_in > 0 &&
           read_qmat(f, &m->conv.w) && read_fvec(f, &m->conv.b) &&
           m->conv.w.rows == static_cast<int>(k * c_in) &&
           m->conv.b.size() == static_cast<size_t>(m->conv.w.cols);
      if (ok) {
        m->conv.k = static_cast<int>(k);
        m->conv.c_in = static_cast<int>(c_in);
        m->conv.filters = m->conv.w.cols;
        m->conv.buf.assign(static_cast<size_t>(k) * c_in, 0.0f);
        m->conv.out.assign(m->conv.filters, 0.0f);
      }
    }
  }
  for (uint32_t li = 0; ok && li < n_layers; ++li) {
    uint8_t kind = 0;
    ok = read_exact(f, &kind, 1);
    if (!ok) break;
    Layer L;
    if (kind == 'd') {
      ok = read_qmat(f, &L.Wcat) && read_qmat(f, &L.Ucat) && read_fvec(f, &L.bcat);
      L.units = L.Ucat.rows;
      L.w_reduced = L.u_reduced = false;
    } else if (kind == 'r') {
      FlatMat wB[4], uB[4];
      for (int g = 0; ok && g < 4; ++g) {
        FlatMat C;
        ok = read_qmat(f, &wB[g]) && read_qmat(f, &C);
        if (ok) place_C(std::move(C), &L.wC[g], &L.wCdot[g]);
      }
      for (int g = 0; ok && g < 4; ++g) {
        FlatMat C;
        ok = read_qmat(f, &uB[g]) && read_qmat(f, &C);
        if (ok) place_C(std::move(C), &L.uC[g], &L.uCdot[g]);
      }
      ok = ok && read_fvec(f, &L.bcat);
      if (ok) finalize_reduced_sides(&L, wB, uB, force_two_step, 4);
    } else if (kind == 'm' && version >= 2) {
      FlatMat wB[1], uB[1], C;
      ok = read_qmat(f, &wB[0]) && read_qmat(f, &C);
      if (ok) place_C(std::move(C), &L.wC[0], &L.wCdot[0]);
      ok = ok && read_qmat(f, &uB[0]) && read_qmat(f, &C);
      if (ok) place_C(std::move(C), &L.uC[0], &L.uCdot[0]);
      ok = ok && read_fvec(f, &L.bcat);
      if (ok) finalize_reduced_sides(&L, wB, uB, force_two_step, 1);
    } else {
      ok = false;
    }
    if (ok) {
      L.h.assign(L.units, 0.0f);
      L.c.assign(L.units, 0.0f);
      L.zg.assign(4 * L.units, 0.0f);
      L.zs.assign(4 * L.units, 0.0f);
      m->layers.push_back(std::move(L));
    }
  }
  if (ok) {
    ok = read_fvec(f, &m->head_w);
    float hb = 0.0f;
    ok = ok && read_exact(f, &hb, 4);
    m->head_b = hb;
    // same head/last-layer size contract as svdlstm_load
    ok = ok && !m->layers.empty() &&
         m->head_w.size() == static_cast<size_t>(m->layers.back().units);
    // conv front end must feed layer 0 exactly
    if (ok && m->conv.present()) {
      const Layer& L0 = m->layers.front();
      const int in0 = L0.w_reduced ? L0.wBcat.rows : L0.Wcat.rows;
      ok = m->conv.filters == in0;
    }
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// dirs: colon-separated layer directories, then dense_top dir.
// kind per layer (string, one char per layer): 'd' dense; 'r' reduced
// (split, per-gate factors) with load-time execution dispatch (sides
// whose ranks can't pay for the exact two-step are reconstructed to
// dense — never slower than dense); 'R' reduced, two-step FORCED on both
// sides (benchmarking/debugging); 'm'/'M' the merged-kernel reduced
// equivalents (one SVD per side spanning all four gates).
void* svdlstm_load(const char* base, const char* layer_dirs,
                   const char* kinds, int transposed) {
  auto* m = new Model();
  std::string basedir(base), dirs(layer_dirs), kindstr(kinds);
  // split the dir list up front so a dirs/kinds count mismatch fails
  // loudly instead of silently building a truncated model
  std::vector<std::string> dirlist;
  size_t pos = 0;
  while (pos != std::string::npos) {
    size_t next = dirs.find(':', pos);
    dirlist.push_back(
        dirs.substr(pos, next == std::string::npos ? next : next - pos));
    pos = (next == std::string::npos) ? next : next + 1;
  }
  if (dirlist.empty() || dirlist.size() != kindstr.size()) {
    delete m;
    return nullptr;
  }
  for (size_t li = 0; li < dirlist.size(); ++li) {
    std::string d = basedir + "/" + dirlist[li];
    Layer L;
    const char k = kindstr[li];
    bool ok;
    if (k == 'r' || k == 'R') ok = load_reduced_layer(d, &L, k == 'R');
    else if (k == 'm' || k == 'M') ok = load_merged_layer(d, &L, k == 'M');
    else if (k == 'd') ok = load_dense_layer(d, &L, transposed != 0);
    else ok = false;
    if (!ok) {
      delete m;
      return nullptr;
    }
    L.h.assign(L.units, 0.0f);
    L.c.assign(L.units, 0.0f);
    L.zg.assign(4 * L.units, 0.0f);
    L.zs.assign(4 * L.units, 0.0f);  // packed-B temp: sum r_g <= 4n
    m->layers.push_back(std::move(L));
  }
  Mat w, b;
  if (!load_csv(basedir + "/dense_top/weights.csv", &w) ||
      !load_csv(basedir + "/dense_top/bias.csv", &b)) {
    delete m;
    return nullptr;
  }
  for (auto& row : w)
    for (float v : row) m->head_w.push_back(v);
  m->head_b = b[0][0];
  // The head dot in svdlstm_step runs over head_w against the last
  // layer's h — a size mismatch (e.g. a multi-output head the CSV
  // exporter happily writes) would read past the h buffer.
  if (m->head_w.size() != static_cast<size_t>(m->layers.back().units)) {
    delete m;
    return nullptr;
  }
  // Optional causal-conv front end (conv hybrids): a conv/ directory next
  // to the lstm_* dirs. Present-but-broken must fail the whole load, and
  // the conv's filter count must be layer 0's input width.
  FILE* probe = std::fopen((basedir + "/conv/w.csv").c_str(), "r");
  if (probe) {
    std::fclose(probe);
    const Layer& L0 = m->layers.front();
    const int in0 = L0.w_reduced ? L0.wBcat.rows : L0.Wcat.rows;
    if (!load_conv(basedir + "/conv", &m->conv) || m->conv.filters != in0) {
      delete m;
      return nullptr;
    }
  }
  return m;
}

// Load the int8 binary artifact (io/int8_export.py writes it).
// force_two_step != 0 disables the load-time dense-reconstruction
// dispatch (benchmarking/debugging the raw factored path).
void* svdlstm_load_int8_ex(const char* path, int force_two_step) {
  auto* m = new Model();
  if (!load_int8_model(path, m, force_two_step != 0)) {
    delete m;
    return nullptr;
  }
  return m;
}

void* svdlstm_load_int8(const char* path) {
  return svdlstm_load_int8_ex(path, 0);
}

// Introspect layer `li`'s chosen execution paths: fills {w_reduced,
// u_reduced, units}. Returns 0 on bad index. Lets tests/benchmarks
// verify what the load-time dispatch decided.
int svdlstm_layer_info(void* handle, int li, int* w_reduced, int* u_reduced,
                       int* units) {
  auto* m = static_cast<Model*>(handle);
  if (li < 0 || li >= static_cast<int>(m->layers.size())) return 0;
  const Layer& L = m->layers[li];
  if (w_reduced) *w_reduced = L.w_reduced ? 1 : 0;
  if (u_reduced) *u_reduced = L.u_reduced ? 1 : 0;
  if (units) *units = L.units;
  return 1;
}

void svdlstm_reset(void* handle) {
  auto* m = static_cast<Model*>(handle);
  std::fill(m->conv.buf.begin(), m->conv.buf.end(), 0.0f);
  for (auto& L : m->layers) {
    std::fill(L.h.begin(), L.h.end(), 0.0f);
    std::fill(L.c.begin(), L.c.end(), 0.0f);
  }
}

// Input width the loaded model expects per frame (the conv front end's
// channel count when present, else layer 0's in_dim).
int svdlstm_input_dim(void* handle) {
  auto* m = static_cast<Model*>(handle);
  if (m->conv.present()) return m->conv.c_in;
  if (m->layers.empty()) return 0;
  const Layer& L = m->layers.front();
  return L.w_reduced ? L.wBcat.rows : L.Wcat.rows;
}

// One frame in, one prediction out (state carried inside the handle).
// A frame narrower/wider than the model's input width would read out of
// bounds inside layer_step; refuse with a quiet NaN instead (callers fed
// by external pipes — the LabVIEW consumer role — can't be trusted to
// size frames correctly). Pass d < 0 to skip the check (legacy callers).
float svdlstm_step(void* handle, const float* frame, int d) {
  if (d >= 0 && d != svdlstm_input_dim(handle))
    return std::numeric_limits<float>::quiet_NaN();
  auto* m = static_cast<Model*>(handle);
  const float* x = frame;
  if (m->conv.present()) {
    conv_step(m->conv, frame);
    x = m->conv.out.data();
  }
  for (auto& L : m->layers) {
    layer_step(L, x);
    x = L.h.data();
  }
  float y = m->head_b;
  for (size_t j = 0; j < m->head_w.size(); ++j) y += x[j] * m->head_w[j];
  return y;
}

// Run a whole sequence: frames row-major (T x d), out (T).
void svdlstm_run(void* handle, const float* frames, int T, int d, float* out) {
  for (int t = 0; t < T; ++t) out[t] = svdlstm_step(handle, frames + t * d, d);
}

void svdlstm_free(void* handle) { delete static_cast<Model*>(handle); }

}  // extern "C"
