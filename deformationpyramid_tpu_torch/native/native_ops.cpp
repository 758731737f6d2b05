// Host-side collate ops of the PyTorch port, with a plain C interface.
//
// The two algorithms of the JAX package's native library
// (cxx/native_ops.cpp), copied unchanged behind a C ABI (no Python.h, no
// numpy headers: the caller allocates every output and binds the
// functions with ctypes), so that both libraries give the same bits:
//   * dp_grid_subsample   <- the reference's cpp_wrappers/cpp_subsampling:
//     voxel barycentres in first-appearance order, sums in double;
//   * dp_radius_neighbors <- cpp_wrappers/cpp_neighbors: fixed-radius
//     neighbours through a uniform hash of radius-sized cells (the 27 cells
//     around a query), kept where d2 <= r2 in double, ordered by (d2, j),
//     the first max_k written, shadow index ns where fewer are found.
// Every entry point returns a negative value where it fails (an
// allocation); it never throws across the C boundary.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        // large-prime mix; point clouds are small enough that collisions
        // just cost a compare
        return static_cast<size_t>(
            k.x * 73856093LL ^ k.y * 19349669LL ^ k.z * 83492791LL);
    }
};

CellKey cell_of(const float* p, double size) {
    return CellKey{static_cast<int64_t>(std::floor(p[0] / size)),
                   static_cast<int64_t>(std::floor(p[1] / size)),
                   static_cast<int64_t>(std::floor(p[2] / size))};
}

}  // namespace

// points [n, 3] -> barycentres out [m, 3] (out holds n rows); returns m.
extern "C" int64_t dp_grid_subsample(const float* p, int64_t n, double dl,
                                     float* out) {
    try {
        std::unordered_map<CellKey, int64_t, CellHash> voxel_id;
        voxel_id.reserve(static_cast<size_t>(n));
        std::vector<double> sums;   // [m * 3]
        std::vector<int64_t> counts;
        for (int64_t i = 0; i < n; ++i) {
            const CellKey key = cell_of(p + 3 * i, dl);
            auto it = voxel_id.find(key);
            int64_t id;
            if (it == voxel_id.end()) {
                id = static_cast<int64_t>(counts.size());
                voxel_id.emplace(key, id);
                sums.insert(sums.end(), {0.0, 0.0, 0.0});
                counts.push_back(0);
            } else {
                id = it->second;
            }
            sums[3 * id + 0] += p[3 * i + 0];
            sums[3 * id + 1] += p[3 * i + 1];
            sums[3 * id + 2] += p[3 * i + 2];
            counts[id] += 1;
        }
        const int64_t m = static_cast<int64_t>(counts.size());
        for (int64_t i = 0; i < m; ++i) {
            const double c = static_cast<double>(counts[i]);
            out[3 * i + 0] = static_cast<float>(sums[3 * i + 0] / c);
            out[3 * i + 1] = static_cast<float>(sums[3 * i + 1] / c);
            out[3 * i + 2] = static_cast<float>(sums[3 * i + 2] / c);
        }
        return m;
    } catch (...) {
        return -1;
    }
}

// queries [nq, 3], supports [ns, 3] -> out [nq, max_k], distance-ordered
// support indices, shadow index ns; returns 0.
extern "C" int dp_radius_neighbors(const float* qp, int64_t nq,
                                   const float* sp, int64_t ns,
                                   double radius, int64_t max_k,
                                   int64_t* out) {
    try {
        std::fill(out, out + nq * max_k, ns);
        if (ns <= 0 || !(radius > 0.0)) return 0;
        // bucket supports into radius-sized cells
        const double cell = radius;
        std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
        grid.reserve(static_cast<size_t>(ns));
        for (int64_t i = 0; i < ns; ++i) grid[cell_of(sp + 3 * i, cell)]
            .push_back(i);

        const double r2 = radius * radius;
        std::vector<std::pair<float, int64_t>> cand;
        for (int64_t i = 0; i < nq; ++i) {
            const float qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
            const CellKey c = cell_of(qp + 3 * i, cell);
            cand.clear();
            for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
            for (int64_t dz = -1; dz <= 1; ++dz) {
                auto it = grid.find(CellKey{c.x + dx, c.y + dy, c.z + dz});
                if (it == grid.end()) continue;
                for (int64_t j : it->second) {
                    const float ddx = sp[3 * j] - qx;
                    const float ddy = sp[3 * j + 1] - qy;
                    const float ddz = sp[3 * j + 2] - qz;
                    const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                    if (d2 <= r2) cand.emplace_back(d2, j);
                }
            }
            const size_t k = std::min(cand.size(),
                                      static_cast<size_t>(max_k));
            std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
            for (size_t j = 0; j < k; ++j) out[i * max_k + j] = cand[j].second;
        }
        return 0;
    } catch (...) {
        return -1;
    }
}
