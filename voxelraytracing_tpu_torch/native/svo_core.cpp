// svo_core: native host runtime for the voxelraytracing_tpu engine.
//
// The device (TPU) owns all per-pixel/per-voxel bulk compute; this library
// owns the *latency-sensitive host mutations* that sit on the interactive
// path — the role the reference engine's Rust `common::world` core plays
// (common/src/world/mod.rs:137-471): 16-bit SVO node format, group-of-8
// free-list allocation with coalescing, top-down split on write, bottom-up
// merge of identical siblings, plus dense<->SVO conversion used by the
// server authority and region-file loads.
//
// Semantics intentionally match the Python reference implementation in
// core/svo.py (which is itself the executable spec, property-tested); the
// test suite cross-checks this library against it operation-for-operation.
//
// Exposed as a plain C ABI for ctypes. Nodes are int32 holding widened
// 16-bit node values (MSB-of-16 split flag, low 15 bits payload).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t SPLIT_MASK = 0x8000;
constexpr int32_t DATA_MASK = 0x7FFF;
constexpr int CHUNK_SIZE = 32;
constexpr int CHUNK_DEPTH = 5;

inline bool is_split(int32_t n) { return (n & SPLIT_MASK) != 0; }
inline int32_t leaf(int32_t voxel) { return voxel & DATA_MASK; }
inline int32_t split(int32_t child) { return child | SPLIT_MASK; }
inline int32_t payload(int32_t n) { return n & DATA_MASK; }

// Free-list allocator over [start,end) handing out aligned groups of 8,
// coalescing on free (reference semantics: common/src/world/mod.rs:213-313,
// spec: core/svo.py NodeAlloc).
struct Alloc {
  std::vector<int64_t> free_start;
  std::vector<int64_t> free_end;
  int64_t range_end = 0;
  int64_t last_used = 0;

  void init(int64_t used_end, int64_t end) {
    free_start.assign(1, used_end);
    free_end.assign(1, end);
    range_end = end;
    last_used = used_end - 1;
  }

  int64_t next() {
    int best = -1;
    int64_t best_addr = 0;
    for (size_t i = 0; i < free_start.size(); i++) {
      if (free_end[i] - free_start[i] < 8) continue;
      if (best < 0 || free_start[i] < best_addr) {
        best = (int)i;
        best_addr = free_start[i];
      }
    }
    if (best < 0) return -1;
    int64_t result = free_start[best];
    free_start[best] += 8;
    // drop a span once only a single unusable slot remains
    if (free_start[best] + 1 == free_end[best]) {
      free_start.erase(free_start.begin() + best);
      free_end.erase(free_end.begin() + best);
    }
    if (result + 7 > last_used) last_used = result + 7;
    return result;
  }

  void free_group(int64_t addr) {
    int64_t end = addr + 8;
    for (size_t i = 0; i < free_start.size(); i++) {
      if (free_start[i] == end) {
        free_start[i] -= 8;
        return;
      }
      if (free_end[i] == addr) {
        free_end[i] += 8;
        return;
      }
    }
    free_start.push_back(addr);
    free_end.push_back(end);
  }
};

struct Found {
  int64_t idx;
  int depth;
  float cx, cy, cz;
  int size;
};

Found find_node(const int32_t* nodes, float px, float py, float pz,
                int max_depth) {
  Found f{0, 0, CHUNK_SIZE * 0.5f, CHUNK_SIZE * 0.5f, CHUNK_SIZE * 0.5f,
          CHUNK_SIZE};
  while (true) {
    int32_t n = nodes[f.idx];
    if (!is_split(n) || f.depth == max_depth) return f;
    f.size /= 2;
    int cx = px >= f.cx, cy = py >= f.cy, cz = pz >= f.cz;
    f.idx = payload(n) + (cx | (cy << 1) | (cz << 2));
    float h = f.size * 0.5f;
    f.cx += cx ? h : -h;
    f.cy += cy ? h : -h;
    f.cz += cz ? h : -h;
    f.depth++;
  }
}

Found node_parent(const int32_t* nodes, const Found& child) {
  Found f{0, 0, CHUNK_SIZE * 0.5f, CHUNK_SIZE * 0.5f, CHUNK_SIZE * 0.5f,
          CHUNK_SIZE};
  while (true) {
    int32_t n = nodes[f.idx];
    if (!is_split(n) || f.depth == child.depth - 1) return f;
    f.size /= 2;
    int cx = child.cx >= f.cx, cy = child.cy >= f.cy, cz = child.cz >= f.cz;
    f.idx = payload(n) + (cx | (cy << 1) | (cz << 2));
    float h = f.size * 0.5f;
    f.cx += cx ? h : -h;
    f.cy += cy ? h : -h;
    f.cz += cz ? h : -h;
    f.depth++;
  }
}

}  // namespace

extern "C" {

// Opaque allocator handle management (one per chunk span).
void* svo_alloc_new(int64_t used_end, int64_t end) {
  Alloc* a = new Alloc();
  a->init(used_end, end);
  return a;
}

void svo_alloc_delete(void* alloc) { delete static_cast<Alloc*>(alloc); }

int64_t svo_alloc_last_used(void* alloc) {
  return static_cast<Alloc*>(alloc)->last_used;
}

int64_t svo_alloc_total_free(void* alloc) {
  Alloc* a = static_cast<Alloc*>(alloc);
  int64_t total = 0;
  for (size_t i = 0; i < a->free_start.size(); i++)
    total += a->free_end[i] - a->free_start[i];
  return total;
}

// Write `voxel` at (x,y,z)/target_depth into a chunk-relative node array.
// Returns 0 ok, -1 out of memory (pool unchanged semantics not guaranteed
// past the failed split, matching the Python spec's exception point).
int svo_set_node(int32_t* nodes, void* alloc_handle, float x, float y,
                 float z, int32_t voxel, int target_depth) {
  Alloc* alloc = static_cast<Alloc*>(alloc_handle);
  Found f = find_node(nodes, x, y, z, target_depth);
  int32_t parent_voxel = payload(nodes[f.idx]);
  if (parent_voxel == (voxel & DATA_MASK)) return 0;

  while (f.depth < target_depth) {
    int64_t first_child = alloc->next();
    if (first_child < 0) return -1;
    for (int i = 0; i < 8; i++) nodes[first_child + i] = leaf(parent_voxel);
    nodes[f.idx] = split((int32_t)first_child);
    f.size /= 2;
    int cx = x >= f.cx, cy = y >= f.cy, cz = z >= f.cz;
    f.idx = first_child + (cx | (cy << 1) | (cz << 2));
    float h = f.size * 0.5f;
    f.cx += cx ? h : -h;
    f.cy += cy ? h : -h;
    f.cz += cz ? h : -h;
    f.depth++;
  }
  nodes[f.idx] = leaf(voxel);

  // bottom-up merge of 8 identical siblings (mod.rs:442-457)
  while (f.depth > 0) {
    Found parent = node_parent(nodes, f);
    f = parent;
    int64_t base = payload(nodes[f.idx]);
    bool all_eq = true;
    for (int i = 1; i < 8; i++)
      if (nodes[base + i] != nodes[base]) {
        all_eq = false;
        break;
      }
    if (!all_eq) break;
    alloc->free_group(base);
    nodes[f.idx] = leaf(voxel);
  }
  return 0;
}

// Voxel id at (x,y,z) in a chunk-relative node array.
int32_t svo_get_voxel(const int32_t* nodes, float x, float y, float z) {
  Found f = find_node(nodes, x, y, z, CHUNK_DEPTH);
  return payload(nodes[f.idx]);
}

// Expand a chunk SVO into a dense uint16[32][32][32] grid (x-major:
// out[x*1024 + y*32 + z]).
void svo_to_dense(const int32_t* nodes, uint16_t* out) {
  struct Item {
    int64_t idx;
    int mx, my, mz, size;
  };
  std::vector<Item> stack;
  stack.push_back({0, 0, 0, 0, CHUNK_SIZE});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    int32_t n = nodes[it.idx];
    if (!is_split(n) || it.size == 1) {
      uint16_t v = (uint16_t)payload(n);
      for (int x = it.mx; x < it.mx + it.size; x++)
        for (int y = it.my; y < it.my + it.size; y++) {
          uint16_t* row = out + (size_t)x * 1024 + (size_t)y * 32 + it.mz;
          for (int z = 0; z < it.size; z++) row[z] = v;
        }
      continue;
    }
    int64_t base = payload(n);
    int half = it.size / 2;
    for (int c = 0; c < 8; c++) {
      stack.push_back({base + c, it.mx + (c & 1) * half,
                       it.my + ((c >> 1) & 1) * half,
                       it.mz + ((c >> 2) & 1) * half, half});
    }
  }
}

// Build a compact SVO from a dense grid bottom-up (two passes: uniformity
// pyramid, then BFS addressing) — same output layout as the device builder
// (ops/svo_build.py): root at 0, 8-child blocks in scan order.
// Returns the node count, or -1 if it exceeds `cap`.
int64_t dense_to_svo(const uint16_t* grid, int32_t* out, int64_t cap) {
  // vals[l]: value of each cell if uniform; unis[l]: uniformity flags
  static thread_local std::vector<uint16_t> vals[CHUNK_DEPTH + 1];
  static thread_local std::vector<uint8_t> unis[CHUNK_DEPTH + 1];
  for (int l = 0; l <= CHUNK_DEPTH; l++) {
    int s = 1 << l;
    vals[l].resize((size_t)s * s * s);
    unis[l].resize((size_t)s * s * s);
  }
  // leaves (x-major input)
  {
    int s = CHUNK_SIZE;
    for (int x = 0; x < s; x++)
      for (int y = 0; y < s; y++)
        for (int z = 0; z < s; z++) {
          size_t i = ((size_t)x * s + y) * s + z;
          vals[CHUNK_DEPTH][i] = grid[i];
          unis[CHUNK_DEPTH][i] = 1;
        }
  }
  for (int l = CHUNK_DEPTH - 1; l >= 0; l--) {
    int s = 1 << l, s2 = s * 2;
    for (int x = 0; x < s; x++)
      for (int y = 0; y < s; y++)
        for (int z = 0; z < s; z++) {
          uint16_t v0 = 0;
          bool uni = true;
          for (int c = 0; c < 8; c++) {
            int xx = 2 * x + (c & 1), yy = 2 * y + ((c >> 1) & 1),
                zz = 2 * z + ((c >> 2) & 1);
            size_t ci = ((size_t)xx * s2 + yy) * s2 + zz;
            if (c == 0)
              v0 = vals[l + 1][ci];
            else if (vals[l + 1][ci] != v0)
              uni = false;
            if (!unis[l + 1][ci]) uni = false;
          }
          size_t i = ((size_t)x * s + y) * s + z;
          vals[l][i] = v0;
          unis[l][i] = (uint8_t)uni;
        }
  }
  // Top-down, level-synchronous addressing in cell scan order — child
  // blocks of level l are assigned by exclusive prefix sum over the level's
  // split cells, which makes the output bit-identical to the device
  // builder's (ops/svo_build.py:71-113).
  static thread_local std::vector<int64_t> addr[CHUNK_DEPTH + 1];
  static thread_local std::vector<uint8_t> exists[CHUNK_DEPTH + 1];
  for (int l = 0; l <= CHUNK_DEPTH; l++) {
    int s = 1 << l;
    addr[l].assign((size_t)s * s * s, 0);
    exists[l].assign((size_t)s * s * s, 0);
  }
  exists[0][0] = 1;
  addr[0][0] = 0;
  int64_t next_free = 1;
  for (int l = 0; l <= CHUNK_DEPTH; l++) {
    int s = 1 << l;
    size_t n_cells = (size_t)s * s * s;
    for (size_t i = 0; i < n_cells; i++) {
      if (!exists[l][i]) continue;
      bool do_split = !unis[l][i] && l < CHUNK_DEPTH;
      int64_t a = addr[l][i];
      if (a >= cap) return -1;
      if (!do_split) {
        out[a] = leaf(vals[l][i]);
        continue;
      }
      int64_t base = next_free;
      next_free += 8;
      if (base + 7 >= cap || base > DATA_MASK) return -1;
      out[a] = split((int32_t)base);
      // decompose scan index (x slowest, z fastest)
      int z = (int)(i % s), y = (int)((i / s) % s), x = (int)(i / ((size_t)s * s));
      int s2 = s * 2;
      for (int ch = 0; ch < 8; ch++) {
        int xx = 2 * x + (ch & 1), yy = 2 * y + ((ch >> 1) & 1),
            zz = 2 * z + ((ch >> 2) & 1);
        size_t ci = ((size_t)xx * s2 + yy) * s2 + zz;
        exists[l + 1][ci] = 1;
        addr[l + 1][ci] = base + ch;
      }
    }
  }
  return next_free;
}

// Batched dense->SVO: `count` grids, each 32768 uint16; outputs are
// `stride`-spaced. n_out[i] = node count or -1.
void dense_to_svo_batch(const uint16_t* grids, int64_t count, int32_t* out,
                        int64_t stride, int64_t* n_out) {
  for (int64_t i = 0; i < count; i++) {
    n_out[i] = dense_to_svo(grids + i * 32768, out + i * stride, stride);
  }
}

// Per-row 256-bin histogram of uint8 ids: out[r*256 + id] = count.
// The streaming render-grid builder's palette pass spends most of its
// time in the equivalent np.bincount (ops/wavefront3.py
// build_sw_palettes); this is the same computation at memory speed.
void hist256_u8(const uint8_t* ids, int64_t rows, int64_t row_len,
                int32_t* out) {
  for (int64_t r = 0; r < rows; r++) {
    int32_t* o = out + r * 256;
    for (int i = 0; i < 256; i++) o[i] = 0;
    const uint8_t* p = ids + r * row_len;
    for (int64_t i = 0; i < row_len; i++) o[p[i]]++;
  }
}

// Full per-subwindow render data for a batch of 16³ rows of render ids
// (the streaming builder's hot path — world/render_grid.py
// chunk_batch_sw_data). Semantics are pinned to the NumPy implementation
// by tests/test_native.py: solid/liquid bit rows, brick-skip metas,
// ≤16-entry solid-id palettes (count-desc id-asc eviction on overflow)
// and the 4 palette-index bit planes.
//
// Layouts (all little-endian bit packing, voxel l = x + y*16 + z*256):
//   sw_solid/sw_liq u32[rows,128], sw_meta u32[rows,8]
//   (words 0-1 brick jump bits, 2-3 brick all-liquid bits, 4-7 palette
//   pack-ids 4×u8/word), sw_pid u32[rows,4,128].
void sw_rows_build(const uint8_t* rg, int64_t rows, int32_t n_liquid,
                   const int32_t* to_pack, uint32_t* sw_solid,
                   uint32_t* sw_liq, uint32_t* sw_meta, uint32_t* sw_pid,
                   uint8_t* any_solid, uint8_t* all_liq, uint8_t* any_liq,
                   int32_t* palettes_ok) {
  *palettes_ok = 1;
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* p = rg + r * 4096;
    uint32_t* sol = sw_solid + r * 128;
    uint32_t* liq = sw_liq + r * 128;
    uint32_t* meta = sw_meta + r * 8;
    uint32_t* pid = sw_pid + r * 4 * 128;
    for (int w = 0; w < 128; w++) { sol[w] = 0; liq[w] = 0; }
    for (int j = 0; j < 4 * 128; j++) pid[j] = 0;
    int32_t cnt[256] = {0};
    bool anyS = false, anyL = false, allL = true;
    uint64_t bAnyS = 0, bAnyL = 0, bAllL = ~0ull;
    for (int l = 0; l < 4096; l++) {
      uint8_t id = p[l];
      bool s = id > n_liquid;
      bool q = id >= 1 && id <= n_liquid;
      int bidx = ((l >> 2) & 3) + (((l >> 6) & 3) << 2) + (((l >> 10) & 3) << 4);
      if (s) {
        sol[l >> 5] |= 1u << (l & 31);
        cnt[id]++;
        anyS = true;
        bAnyS |= 1ull << bidx;
      }
      if (q) {
        liq[l >> 5] |= 1u << (l & 31);
        anyL = true;
        bAnyL |= 1ull << bidx;
      } else {
        allL = false;
        bAllL &= ~(1ull << bidx);
      }
    }
    cnt[0] = 0;
    int n_ids = 0;
    for (int i = 1; i < 256; i++) n_ids += cnt[i] > 0;
    uint8_t lut[256] = {0};
    int32_t pal[16] = {0};
    if (n_ids <= 16) {
      int k = 0;
      for (int i = 1; i < 256 && k < 16; i++)
        if (cnt[i]) { lut[i] = (uint8_t)k; pal[k] = to_pack[i]; k++; }
    } else {
      *palettes_ok = 0;
      bool taken[256] = {false};
      for (int k = 0; k < 16; k++) {
        int best = -1;
        for (int i = 1; i < 256; i++)
          if (cnt[i] && !taken[i] && (best < 0 || cnt[i] > cnt[best]))
            best = i;
        taken[best] = true;
        lut[best] = (uint8_t)k;
        pal[k] = to_pack[best];
      }
    }
    for (int l = 0; l < 4096; l++) {
      uint8_t k = lut[p[l]];
      if (!k) continue;
      uint32_t bit = 1u << (l & 31);
      if (k & 1) pid[0 * 128 + (l >> 5)] |= bit;
      if (k & 2) pid[1 * 128 + (l >> 5)] |= bit;
      if (k & 4) pid[2 * 128 + (l >> 5)] |= bit;
      if (k & 8) pid[3 * 128 + (l >> 5)] |= bit;
    }
    uint64_t bJump = ~bAnyS & (bAllL | ~bAnyL);
    meta[0] = (uint32_t)bJump;
    meta[1] = (uint32_t)(bJump >> 32);
    meta[2] = (uint32_t)bAllL;
    meta[3] = (uint32_t)(bAllL >> 32);
    for (int j = 0; j < 4; j++)
      meta[4 + j] = (uint32_t)pal[j * 4] | ((uint32_t)pal[j * 4 + 1] << 8) |
                    ((uint32_t)pal[j * 4 + 2] << 16) |
                    ((uint32_t)pal[j * 4 + 3] << 24);
    any_solid[r] = anyS;
    all_liq[r] = allL;
    any_liq[r] = anyL;
  }
}

}  // extern "C"
