// Connected-component labeling + small-region cleanup for SAM2's AMG
// postprocessor (upstream sam2 uses a CUDA CCL op / cv2.connectedComponents
// inside postprocess_small_regions; the reference disables it on the grid
// path, generate_prompts_grid.py:66, but the API surface exists).
//
// Host-side union-find over 4-connectivity. Exposed via ctypes:
//   sola_ccl_label(mask, h, w, labels_out) -> n_components (background = 0)
//   sola_ccl_remove_small(mask, h, w, min_area, mode) -> n_changed
//     mode 0: "holes"   — fill background components < min_area
//     mode 1: "islands" — drop foreground components < min_area

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
};

// two-pass 4-connectivity labeling of ``value`` pixels; labels start at 1
int64_t label_value(const uint8_t* mask, int64_t h, int64_t w, uint8_t value,
                    int32_t* labels) {
  const int64_t n = h * w;
  std::vector<int32_t> provisional(n, 0);
  // a new provisional label needs left and up both unset, so 4-connectivity
  // admits at most ceil(n/2) labels (checkerboard) — pre-size, never grow
  UnionFind uf(static_cast<size_t>(n / 2 + 3));
  int32_t next = 1;
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int64_t i = y * w + x;
      if ((mask[i] != 0) != (value != 0)) {
        provisional[i] = 0;
        continue;
      }
      // 8-connectivity (upstream cv2.connectedComponentsWithStats(_, 8))
      int32_t neigh[4] = {
          (x > 0) ? provisional[i - 1] : 0,
          (y > 0 && x > 0) ? provisional[i - w - 1] : 0,
          (y > 0) ? provisional[i - w] : 0,
          (y > 0 && x + 1 < w) ? provisional[i - w + 1] : 0,
      };
      int32_t first = 0;
      for (int32_t lbl : neigh) {
        if (!lbl) continue;
        if (!first) {
          first = lbl;
        } else {
          uf.unite(first, lbl);
        }
      }
      provisional[i] = first ? first : next++;
    }
  }
  // compress provisional labels to 1..k
  std::vector<int32_t> remap(static_cast<size_t>(next), 0);
  int32_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!provisional[i]) {
      labels[i] = 0;
      continue;
    }
    const int32_t root = uf.find(provisional[i]);
    if (!remap[root]) remap[root] = ++k;
    labels[i] = remap[root];
  }
  return k;
}

}  // namespace

extern "C" {

int64_t sola_ccl_label(const uint8_t* mask, int64_t h, int64_t w,
                       int32_t* labels) {
  return label_value(mask, h, w, 1, labels);
}

int64_t sola_ccl_remove_small(uint8_t* mask, int64_t h, int64_t w,
                              int64_t min_area, int32_t mode) {
  const int64_t n = h * w;
  std::vector<int32_t> labels(static_cast<size_t>(n));
  const uint8_t target = (mode == 0) ? 0 : 1;  // holes: background comps
  const int64_t k = label_value(mask, h, w, target, labels.data());
  if (k == 0) return 0;
  std::vector<int64_t> areas(static_cast<size_t>(k + 1), 0);
  for (int64_t i = 0; i < n; ++i)
    if (labels[i]) ++areas[static_cast<size_t>(labels[i])];
  std::vector<uint8_t> small(static_cast<size_t>(k + 1), 0);
  int64_t n_small = 0;
  int64_t largest = 1;
  for (int64_t c = 1; c <= k; ++c) {
    if (areas[static_cast<size_t>(c)] < min_area) {
      small[static_cast<size_t>(c)] = 1;
      ++n_small;
    }
    if (areas[static_cast<size_t>(c)] > areas[static_cast<size_t>(largest)])
      largest = c;
  }
  // islands mode: if every component is small, keep the largest (upstream
  // amg.remove_small_regions fallback)
  if (mode == 1 && n_small == k && k > 0) {
    small[static_cast<size_t>(largest)] = 0;
    --n_small;
  }
  if (n_small == 0) return 0;
  int64_t changed = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] && small[static_cast<size_t>(labels[i])]) {
      mask[i] = target ? 0 : 1;  // drop island / fill hole
      ++changed;
    }
  }
  return changed;
}

}  // extern "C"
