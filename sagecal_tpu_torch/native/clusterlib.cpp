// Native core for the buildsky tool: connected-component island
// labeling and weighted k-means sky clustering.
//
// Role of the reference's embedded C Clustering Library + island walk
// (the C SAGECal's src/buildsky/cluster.c, scluster.c:675-941,
// buildsky.c island scans) — reimplemented from scratch as a small
// C++ library with a C ABI for ctypes loading.  The numeric behavior
// follows the standard algorithms (8-connected flood fill; Lloyd
// iterations with flux-weighted centroids), not the reference's code.
//
// Build:  sagecal_tpu_torch/tools/_native.py runs g++ -O2 -shared -fPIC
// into sagecal_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <random>

extern "C" {

// 8-connected component labeling of mask (ny*nx int8), labels out
// (ny*nx int32, 0 = background, islands numbered from 1).  Returns the
// island count.
int label_islands(const int8_t *mask, int ny, int nx, int32_t *labels) {
  std::memset(labels, 0, sizeof(int32_t) * (size_t)ny * nx);
  int next = 0;
  std::queue<int> q;
  const int dy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int dx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  for (int y = 0; y < ny; y++) {
    for (int x = 0; x < nx; x++) {
      int idx = y * nx + x;
      if (!mask[idx] || labels[idx]) continue;
      next++;
      labels[idx] = next;
      q.push(idx);
      while (!q.empty()) {
        int cur = q.front();
        q.pop();
        int cy = cur / nx, cx = cur % nx;
        for (int k = 0; k < 8; k++) {
          int yy = cy + dy[k], xx = cx + dx[k];
          if (yy < 0 || yy >= ny || xx < 0 || xx >= nx) continue;
          int nidx = yy * nx + xx;
          if (mask[nidx] && !labels[nidx]) {
            labels[nidx] = next;
            q.push(nidx);
          }
        }
      }
    }
  }
  return next;
}

// Weighted k-means over 2-D points (the sky-clustering core,
// scluster.c kmeans_clustering role): n points (x, y) with weights w,
// k clusters, niter Lloyd iterations, deterministic seeded k-means++
// init.  Outputs assignment (n int32) and centers (k*2 double).
// Returns the number of non-empty clusters.
int kmeans_weighted(const double *x, const double *y, const double *w,
                    int n, int k, int niter, uint64_t seed,
                    int32_t *assign, double *centers) {
  if (n <= 0 || k <= 0) return 0;
  if (k > n) k = n;
  std::mt19937_64 rng(seed);
  std::vector<double> cx(k), cy(k);
  // k-means++ init on weighted distances
  std::vector<double> d2(n, 1e300);
  {
    std::uniform_int_distribution<int> pick(0, n - 1);
    int first = pick(rng);
    cx[0] = x[first];
    cy[0] = y[first];
    for (int c = 1; c < k; c++) {
      double total = 0.0;
      for (int i = 0; i < n; i++) {
        double dx = x[i] - cx[c - 1], dy = y[i] - cy[c - 1];
        double d = dx * dx + dy * dy;
        if (d < d2[i]) d2[i] = d;
        total += d2[i] * (w ? w[i] : 1.0);
      }
      std::uniform_real_distribution<double> u(0.0, total);
      double r = u(rng), acc = 0.0;
      int chosen = n - 1;
      for (int i = 0; i < n; i++) {
        acc += d2[i] * (w ? w[i] : 1.0);
        if (acc >= r) { chosen = i; break; }
      }
      cx[c] = x[chosen];
      cy[c] = y[chosen];
    }
  }
  std::vector<double> sw(k), sx(k), sy(k);
  for (int it = 0; it < niter; it++) {
    for (int c = 0; c < k; c++) sw[c] = sx[c] = sy[c] = 0.0;
    for (int i = 0; i < n; i++) {
      double best = 1e300;
      int bc = 0;
      for (int c = 0; c < k; c++) {
        double dx = x[i] - cx[c], dy = y[i] - cy[c];
        double d = dx * dx + dy * dy;
        if (d < best) { best = d; bc = c; }
      }
      assign[i] = bc;
      double wi = w ? w[i] : 1.0;
      sw[bc] += wi;
      sx[bc] += wi * x[i];
      sy[bc] += wi * y[i];
    }
    for (int c = 0; c < k; c++) {
      if (sw[c] > 0.0) {
        cx[c] = sx[c] / sw[c];
        cy[c] = sy[c] / sw[c];
      }
    }
  }
  int nonempty = 0;
  for (int c = 0; c < k; c++) {
    centers[2 * c] = cx[c];
    centers[2 * c + 1] = cy[c];
    if (sw[c] > 0.0) nonempty++;
  }
  return nonempty;
}

}  // extern "C"
