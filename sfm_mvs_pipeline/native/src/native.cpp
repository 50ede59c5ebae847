// sfm_mvs_pipeline native runtime: the host-side components the reference
// implements in C++ get C++ equivalents here (built once with g++, loaded via
// ctypes). Device compute stays in JAX/Pallas; this is the IO/indexing tier:
//
//   * kd-tree k-nearest-neighbor distances — replaces PCL's KdTreeFLANN path
//     used by the pcl-stats subcommand (ref: src/photogrammetrie/util/
//     PclUtils.cpp:75-89, src/cli/PclStatsCli.cpp:47-63). O(N log N) with
//     OpenMP-parallel queries, mirroring the reference's OMP idiom.
//   * binary-little-endian PLY writers (points + optional color/normals,
//     meshes + faces) — replaces the reference's hand-rolled binary PLY
//     emitters (ref: src/photogrammetrie/util/PclUtils.cpp:401-460,
//     src/photogrammetrie/util/OpenMvsUtils.cpp:214-448).
//   * binary PLY vertex/face reader fast path for the pcl-stats loader
//     (ref: src/cli/PclStatsCli.cpp:42-45).
//
// Build: g++ -O3 -fopenmp -shared -fPIC (driven by native/__init__.py, with a
// pure-numpy fallback when no toolchain is present).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------- kd-tree
// Balanced 3-d tree stored as an index permutation; node = median element of
// its range, split dimension cycles with depth. Build is nth_element-based
// O(N log N); queries keep a bounded max-heap of the k best squared
// distances.

struct KDTree {
  const float* pts;  // n x 3, row-major
  std::vector<int32_t> idx;

  explicit KDTree(const float* p, int64_t n) : pts(p), idx(n) {
    for (int64_t i = 0; i < n; ++i) idx[i] = static_cast<int32_t>(i);
    build(0, n, 0);
  }

  void build(int64_t lo, int64_t hi, int dim) {
    while (hi - lo > 1) {
      int64_t mid = (lo + hi) / 2;
      const float* p = pts;
      std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                       [p, dim](int32_t a, int32_t b) {
                         return p[3 * a + dim] < p[3 * b + dim];
                       });
      int next = dim + 1 == 3 ? 0 : dim + 1;
      // Recurse into the smaller half, loop on the larger one (bounded stack).
      if (mid - lo < hi - mid - 1) {
        build(lo, mid, next);
        lo = mid + 1;
      } else {
        build(mid + 1, hi, next);
        hi = mid;
      }
      dim = next;
    }
  }

  // Max-heap of k best squared distances (k is small; flat array + sift).
  struct Heap {
    float* d;
    int k, size = 0;
    explicit Heap(float* buf, int kk) : d(buf), k(kk) {}
    float worst() const { return size < k ? HUGE_VALF : d[0]; }
    void push(float v) {
      if (size < k) {
        d[size++] = v;
        for (int i = size - 1; i > 0;) {
          int parent = (i - 1) / 2;
          if (d[parent] >= d[i]) break;
          std::swap(d[parent], d[i]);
          i = parent;
        }
      } else if (v < d[0]) {
        d[0] = v;
        for (int i = 0;;) {
          int l = 2 * i + 1, r = l + 1, m = i;
          if (l < k && d[l] > d[m]) m = l;
          if (r < k && d[r] > d[m]) m = r;
          if (m == i) break;
          std::swap(d[m], d[i]);
          i = m;
        }
      }
    }
  };

  void query(int64_t lo, int64_t hi, int dim, const float* q, int32_t self,
             Heap& heap) const {
    if (hi <= lo) return;
    int64_t mid = (lo + hi) / 2;
    int32_t node = idx[mid];
    if (node != self) {
      float dx = q[0] - pts[3 * node];
      float dy = q[1] - pts[3 * node + 1];
      float dz = q[2] - pts[3 * node + 2];
      heap.push(dx * dx + dy * dy + dz * dz);
    }
    float delta = q[dim] - pts[3 * node + dim];
    int next = dim + 1 == 3 ? 0 : dim + 1;
    if (delta < 0) {
      query(lo, mid, next, q, self, heap);
      if (delta * delta < heap.worst()) query(mid + 1, hi, next, q, self, heap);
    } else {
      query(mid + 1, hi, next, q, self, heap);
      if (delta * delta < heap.worst()) query(lo, mid, next, q, self, heap);
    }
  }
};

int fwrite_all(FILE* f, const void* buf, size_t n) {
  return fwrite(buf, 1, n, f) == n ? 0 : -1;
}

}  // namespace

extern "C" {

// Distance to the k-th nearest neighbor (self excluded) for every point.
// pts: n x 3 float32. out: n float32. Returns 0 on success.
int sfm_knn_kth(const float* pts, int64_t n, int32_t k, float* out) {
  if (n <= 0 || k <= 0) return -1;
  if (n <= k) {
    for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
    return 0;
  }
  KDTree tree(pts, n);
#pragma omp parallel
  {
    std::vector<float> heapbuf(k);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      KDTree::Heap heap(heapbuf.data(), k);
      tree.query(0, n, 0, pts + 3 * i, static_cast<int32_t>(i), heap);
      out[i] = std::sqrt(heap.d[0]);
    }
  }
  return 0;
}

// All-k variant: out is n x k (sorted ascending per row).
int sfm_knn_all(const float* pts, int64_t n, int32_t k, float* out) {
  if (n <= 0 || k <= 0) return -1;
  KDTree tree(pts, n);
  int32_t kq = static_cast<int32_t>(std::min<int64_t>(k, n - 1));
#pragma omp parallel
  {
    std::vector<float> heapbuf(kq > 0 ? kq : 1);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      float* row = out + static_cast<int64_t>(k) * i;
      if (kq <= 0) {
        for (int32_t j = 0; j < k; ++j) row[j] = 0.0f;
        continue;
      }
      KDTree::Heap heap(heapbuf.data(), kq);
      tree.query(0, n, 0, pts + 3 * i, static_cast<int32_t>(i), heap);
      std::sort(heapbuf.begin(), heapbuf.begin() + heap.size);
      for (int32_t j = 0; j < k; ++j)
        row[j] = j < heap.size ? std::sqrt(heapbuf[j]) : 0.0f;
    }
  }
  return 0;
}

// Binary little-endian PLY writer: nv vertices (xyz float32), optional rgb
// (nv x 3 uint8, may be null), optional normals (nv x 3 float32, may be
// null), nf faces (nf x 3 int32, may be null / nf == 0). Returns 0 on
// success.
int sfm_write_ply(const char* path, int64_t nv, const float* xyz,
                  const uint8_t* rgb, const float* normals, int64_t nf,
                  const int32_t* faces) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char header[512];
  int len = snprintf(header, sizeof(header),
                     "ply\nformat binary_little_endian 1.0\n"
                     "comment sfm_mvs_pipeline native writer\n"
                     "element vertex %lld\n"
                     "property float x\nproperty float y\nproperty float z\n",
                     static_cast<long long>(nv));
  if (normals)
    len += snprintf(header + len, sizeof(header) - len,
                    "property float nx\nproperty float ny\nproperty float nz\n");
  if (rgb)
    len += snprintf(header + len, sizeof(header) - len,
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\n");
  if (faces && nf > 0)
    len += snprintf(header + len, sizeof(header) - len,
                    "element face %lld\n"
                    "property list uchar int vertex_indices\n",
                    static_cast<long long>(nf));
  len += snprintf(header + len, sizeof(header) - len, "end_header\n");
  int rc = fwrite_all(f, header, static_cast<size_t>(len));

  // Interleave vertices into a buffer (chunked so huge clouds stream).
  const int64_t chunk = 1 << 16;
  size_t stride = 12 + (normals ? 12 : 0) + (rgb ? 3 : 0);
  std::vector<uint8_t> buf(static_cast<size_t>(chunk) * stride);
  for (int64_t s = 0; s < nv && rc == 0; s += chunk) {
    int64_t e = std::min(nv, s + chunk);
    uint8_t* w = buf.data();
    for (int64_t i = s; i < e; ++i) {
      memcpy(w, xyz + 3 * i, 12);
      w += 12;
      if (normals) {
        memcpy(w, normals + 3 * i, 12);
        w += 12;
      }
      if (rgb) {
        memcpy(w, rgb + 3 * i, 3);
        w += 3;
      }
    }
    rc = fwrite_all(f, buf.data(), static_cast<size_t>(w - buf.data()));
  }
  if (faces && nf > 0) {
    size_t fstride = 1 + 12;
    std::vector<uint8_t> fbuf(static_cast<size_t>(chunk) * fstride);
    for (int64_t s = 0; s < nf && rc == 0; s += chunk) {
      int64_t e = std::min(nf, s + chunk);
      uint8_t* w = fbuf.data();
      for (int64_t i = s; i < e; ++i) {
        *w++ = 3;
        memcpy(w, faces + 3 * i, 12);
        w += 12;
      }
      rc = fwrite_all(f, fbuf.data(), static_cast<size_t>(w - fbuf.data()));
    }
  }
  return fclose(f) == 0 ? rc : -1;
}

// Deinterleave a binary PLY vertex payload: in = nv x stride bytes,
// copies `count` bytes from `offset` of each record into out (packed).
// Lets Python parse the header and hand the hot byte-shuffle to C++.
int sfm_deinterleave(const uint8_t* in, int64_t nv, int32_t stride,
                     int32_t offset, int32_t count, uint8_t* out) {
  if (offset + count > stride) return -1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nv; ++i)
    memcpy(out + i * count, in + i * stride + offset, count);
  return 0;
}

}  // extern "C"
