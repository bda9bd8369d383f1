// Native eval operators of the PyTorch port (its own copy of
// wt_pse_tpu/native/evalops.cpp).
//
// The eval path's host-side work — largest-connected-component + hole filling
// (the reference's skimage/scipy cleanup, utils.py:267-329) and
// medpy-semantics surface distances (Trainer.py:226-239) — implemented in C++
// for throughput on full-resolution (up to ~2k^2) test masks. Python bindings
// via ctypes (wt_pse_tpu_torch/native/__init__.py); the scipy paths of
// ops/metrics.py and ops/postprocess.py remain the behavioral oracle.
//
// Algorithms:
//  - connected components: two-pass union-find, 8-connectivity (skimage parity);
//  - hole fill: BFS background flood from the border, 4-connectivity
//    (scipy binary_fill_holes parity);
//  - exact Euclidean distance transform: Felzenszwalb-Huttenlocher separable
//    lower-envelope in O(N) per axis (true EDT, matches
//    scipy.ndimage.distance_transform_edt);
//  - surface distances: border = mask ^ erode(mask, 4-conn cross), distances
//    of a's border voxels sampled from the EDT of b's border complement
//    (medpy __surface_distances semantics).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// connected components (8-connectivity) + keep largest + fill holes (4-conn)
// ---------------------------------------------------------------------------

static int find_root(std::vector<int>& parent, int x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static void unite(std::vector<int>& parent, int a, int b) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
}

// Keep the largest 8-connected component of `mask` (uint8 0/1, in place),
// then fill holes. Returns the number of components found.
int largest_component_fill_holes(uint8_t* mask, int h, int w) {
    const int n = h * w;
    std::vector<int> labels(n, 0);
    std::vector<int> parent(1, 0);  // parent[0] unused (background)
    int next = 1;

    // pass 1: provisional labels + unions (8-connectivity: W, NW, N, NE)
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int i = y * w + x;
            if (!mask[i]) continue;
            int neigh[4];
            int nn = 0;
            if (x > 0 && mask[i - 1]) neigh[nn++] = labels[i - 1];
            if (y > 0) {
                if (x > 0 && mask[i - w - 1]) neigh[nn++] = labels[i - w - 1];
                if (mask[i - w]) neigh[nn++] = labels[i - w];
                if (x + 1 < w && mask[i - w + 1]) neigh[nn++] = labels[i - w + 1];
            }
            if (nn == 0) {
                labels[i] = next;
                parent.push_back(next);
                ++next;
            } else {
                int m = neigh[0];
                for (int k = 1; k < nn; ++k) m = std::min(m, neigh[k]);
                labels[i] = m;
                for (int k = 0; k < nn; ++k) unite(parent, m, neigh[k]);
            }
        }
    }

    // pass 2: resolve + areas
    std::vector<int64_t> area(next, 0);
    for (int i = 0; i < n; ++i) {
        if (!mask[i]) continue;
        const int r = find_root(parent, labels[i]);
        labels[i] = r;
        ++area[r];
    }
    int ncomp = 0;
    int best = 0;
    int64_t best_area = -1;
    for (int r = 1; r < next; ++r) {
        if (parent[r] == r && area[r] > 0) {
            ++ncomp;
            if (area[r] > best_area) {  // first max wins (np.argmax parity)
                best_area = area[r];
                best = r;
            }
        }
    }
    for (int i = 0; i < n; ++i) mask[i] = (mask[i] && labels[i] == best) ? 1 : 0;

    // fill holes: BFS background flood from border, 4-connectivity
    std::vector<uint8_t> reach(n, 0);
    std::vector<int> stack;
    stack.reserve(2 * (h + w));
    auto push_bg = [&](int i) {
        if (!mask[i] && !reach[i]) {
            reach[i] = 1;
            stack.push_back(i);
        }
    };
    for (int x = 0; x < w; ++x) { push_bg(x); push_bg((h - 1) * w + x); }
    for (int y = 0; y < h; ++y) { push_bg(y * w); push_bg(y * w + w - 1); }
    while (!stack.empty()) {
        const int i = stack.back();
        stack.pop_back();
        const int y = i / w, x = i % w;
        if (x > 0) push_bg(i - 1);
        if (x + 1 < w) push_bg(i + 1);
        if (y > 0) push_bg(i - w);
        if (y + 1 < h) push_bg(i + w);
    }
    for (int i = 0; i < n; ++i) if (!mask[i] && !reach[i]) mask[i] = 1;
    return ncomp;
}

// ---------------------------------------------------------------------------
// exact EDT (Felzenszwalb & Huttenlocher), distance to nearest ON pixel
// ---------------------------------------------------------------------------

static void edt_1d(const float* f, float* d, int* v, float* z, int n) {
    const float INF = std::numeric_limits<float>::infinity();
    // build the lower envelope from finite parabolas only
    int k = -1;
    for (int q = 0; q < n; ++q) {
        if (f[q] == INF) continue;
        if (k < 0) {
            k = 0;
            v[0] = q;
            z[0] = -INF;
            z[1] = INF;
            continue;
        }
        float s = ((f[q] + (float)q * q) - (f[v[k]] + (float)v[k] * v[k]))
                  / (2.0f * (q - v[k]));
        while (s <= z[k]) {
            --k;
            if (k < 0) break;
            s = ((f[q] + (float)q * q) - (f[v[k]] + (float)v[k] * v[k]))
                / (2.0f * (q - v[k]));
        }
        ++k;
        v[k] = q;
        z[k] = (k == 0) ? -INF : s;
        z[k + 1] = INF;
    }
    if (k < 0) {  // no seeds on this line
        for (int q = 0; q < n; ++q) d[q] = INF;
        return;
    }
    int j = 0;
    for (int q = 0; q < n; ++q) {
        while (z[j + 1] < q) ++j;
        d[q] = (float)(q - v[j]) * (q - v[j]) + f[v[j]];
    }
}

// out[i] = euclidean distance from pixel i to the nearest pixel with mask!=0
void edt(const uint8_t* mask, int h, int w, float* out) {
    const float INF = std::numeric_limits<float>::infinity();
    std::vector<float> f(std::max(h, w)), d(std::max(h, w)), z(std::max(h, w) + 1);
    std::vector<int> v(std::max(h, w));

    // columns first
    std::vector<float> tmp((size_t)h * w);
    for (int x = 0; x < w; ++x) {
        for (int y = 0; y < h; ++y) f[y] = mask[y * w + x] ? 0.0f : INF;
        edt_1d(f.data(), d.data(), v.data(), z.data(), h);
        for (int y = 0; y < h; ++y) tmp[(size_t)y * w + x] = d[y];
    }
    // rows
    for (int y = 0; y < h; ++y) {
        edt_1d(&tmp[(size_t)y * w], d.data(), v.data(), z.data(), w);
        for (int x = 0; x < w; ++x)
            out[(size_t)y * w + x] = std::isinf(d[x]) ? INF : std::sqrt(d[x]);
    }
}

// ---------------------------------------------------------------------------
// surface distances (medpy semantics)
// ---------------------------------------------------------------------------

static void border_4(const uint8_t* m, uint8_t* b, int h, int w) {
    // border = m ^ erode(m, cross): pixel stays after erosion iff all 4
    // neighbors (with OOB treated as 0, scipy border_value=0) and itself are on
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int i = y * w + x;
            if (!m[i]) { b[i] = 0; continue; }
            const bool inner =
                (y > 0 && m[i - w]) && (y + 1 < h && m[i + w]) &&
                (x > 0 && m[i - 1]) && (x + 1 < w && m[i + 1]);
            b[i] = inner ? 0 : 1;
        }
    }
}

// Distances from each border voxel of `a` to the nearest border voxel of `b`.
// Writes up to h*w floats into `out`; returns the count, or -1 if a or b empty.
int64_t surface_distances(const uint8_t* a, const uint8_t* b, int h, int w,
                          float* out) {
    const int64_t n = (int64_t)h * w;
    bool any_a = false, any_b = false;
    for (int64_t i = 0; i < n; ++i) { any_a |= a[i] != 0; any_b |= b[i] != 0; }
    if (!any_a || !any_b) return -1;
    std::vector<uint8_t> ba(n), bb(n);
    border_4(a, ba.data(), h, w);
    border_4(b, bb.data(), h, w);
    std::vector<float> dt(n);
    edt(bb.data(), h, w, dt.data());
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) if (ba[i]) out[cnt++] = dt[i];
    return cnt;
}

}  // extern "C"
