// Jonker-Volgonant style shortest-augmenting-path LSAP solver (C++), the
// port's copy of gpv_tpu/native/lap.cc (the same solver and g++ flags; the
// batch call spreads its images over threads).
//
// Role in the port: the host half of DETR's Hungarian matching
// (gpv_tpu_torch/ops/matcher.py:solve_costs). The batch's cost matrices
// are built on the card and copied to the host once; solve_lsap_batch then
// solves every image in one call, in place of the reference's per-image
// scipy.optimize.linear_sum_assignment (utils/matcher.py:76), which stays
// the tests' oracle. Every solve reaches the optimum; on exact ties it may
// pick another assignment than scipy.
//
// Build: gpv_tpu_torch/native/build.py (g++ -O3 -march=native -shared).
//
// Exposed C ABI:
//   solve_lsap(cost, n_rows, n_cols, col4row)   // one matrix, row-major
//   solve_lsap_batch(cost, batch, n_rows, n_cols, col4row, threads)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Solve min-cost assignment for an n_rows x n_cols matrix, n_rows <= n_cols.
// Writes the assigned column of each row into col4row.
int solve_one(const float* cost, int n_rows, int n_cols, int32_t* col4row) {
  if (n_rows > n_cols) return -1;
  std::vector<double> u(n_rows, 0.0), v(n_cols, 0.0);
  std::vector<double> shortest(n_cols);
  std::vector<int32_t> path(n_cols), row4col(n_cols, -1);
  std::vector<int32_t> c4r(n_rows, -1);
  std::vector<bool> sr(n_rows), sc(n_cols);

  for (int cur_row = 0; cur_row < n_rows; ++cur_row) {
    std::fill(shortest.begin(), shortest.end(), kInf);
    std::fill(path.begin(), path.end(), -1);
    std::fill(sr.begin(), sr.end(), false);
    std::fill(sc.begin(), sc.end(), false);

    double min_val = 0.0;
    int i = cur_row;
    int sink = -1;
    while (sink == -1) {
      sr[i] = true;
      int best_j = -1;
      double best = kInf;
      const float* row = cost + static_cast<size_t>(i) * n_cols;
      for (int j = 0; j < n_cols; ++j) {
        if (sc[j]) continue;
        double r = min_val + row[j] - u[i] - v[j];
        if (r < shortest[j]) {
          shortest[j] = r;
          path[j] = i;
        }
        if (shortest[j] < best ||
            (shortest[j] == best && row4col[j] == -1)) {
          best = shortest[j];
          best_j = j;
        }
      }
      if (best_j < 0 || best == kInf) return -2;  // infeasible
      min_val = best;
      sc[best_j] = true;
      if (row4col[best_j] == -1) {
        sink = best_j;
      } else {
        i = row4col[best_j];
      }
    }

    u[cur_row] += min_val;
    for (int r = 0; r < n_rows; ++r) {
      if (sr[r] && r != cur_row) u[r] += min_val - shortest[c4r[r]];
    }
    for (int j = 0; j < n_cols; ++j) {
      if (sc[j]) v[j] -= min_val - shortest[j];
    }

    int j = sink;
    while (true) {
      int pi = path[j];
      row4col[j] = pi;
      int next_j = c4r[pi];
      c4r[pi] = j;
      if (pi == cur_row) break;
      j = next_j;
    }
  }
  for (int r = 0; r < n_rows; ++r) col4row[r] = c4r[r];
  return 0;
}

}  // namespace

extern "C" {

int solve_lsap(const float* cost, int n_rows, int n_cols, int32_t* col4row) {
  return solve_one(cost, n_rows, n_cols, col4row);
}

// The images of a batch are independent: `threads` threads take them in
// turn (each image is solved by solve_one, so the result is the serial
// one). Returns the first non-zero code of any image, else 0.
int solve_lsap_batch(const float* cost, int batch, int n_rows, int n_cols,
                     int32_t* col4row, int threads) {
  threads = std::max(1, std::min(threads, batch));
  std::atomic<int> next(0), status(0);
  auto worker = [&]() {
    for (int b = next.fetch_add(1); b < batch; b = next.fetch_add(1)) {
      int rc = solve_one(cost + static_cast<size_t>(b) * n_rows * n_cols,
                         n_rows, n_cols,
                         col4row + static_cast<size_t>(b) * n_rows);
      int ok = 0;
      if (rc != 0) status.compare_exchange_strong(ok, rc);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return status.load();
}

}  // extern "C"
