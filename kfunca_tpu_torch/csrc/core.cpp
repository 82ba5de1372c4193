// The port's native host core: dtype promotion, broadcasting, the loop-nest
// planner, the tape scheduler, and the serving runtime's page pool, request
// queue and prefix-cache index.
//
// The port's own copy of the parts of kfunca_tpu/csrc/kfunca_core.cpp that
// the port calls (kf_promote, kf_accumulate_type, kf_broadcast_shapes,
// kf_plan_loop_nest, kf_tape_schedule, kf_page_pool_*, kf_queue_*,
// kf_pcache_*, kf_bpe_*), with the same C interface and the same answers;
// built by g++ into kfunca_tpu_torch/build/ (runtime/_native.py) and bound
// with ctypes.  Left out: the caching allocator (the port reads
// torch.cuda.memory_stats) and the flash-attention live-grid tables (they
// serve the TPU grid only).  Every entry point
// has a Python form that gives the same answers (KFUNCA_NO_NATIVE=1 selects
// them); tests/test_torch_native_core.py holds the two together.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#define KF_EXPORT extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// dtype promotion (reference tensor_iterator.cpp:32-44) + accumulate type
// (accumulate_type.h). Enum values match kfunca_tpu.core.dtype.ScalarType.
// ---------------------------------------------------------------------------

namespace {
enum ScalarType : int8_t {
    kBool = 0, kByte, kChar, kShort, kInt, kLong,
    kHalf, kBFloat16, kFloat, kDouble, kUndefined
};

bool is_float(int8_t t) { return t == kHalf || t == kBFloat16 || t == kFloat || t == kDouble; }
bool is_uint(int8_t t) { return t == kByte; }
} // namespace

KF_EXPORT int8_t kf_promote(int8_t a, int8_t b) {
    if (a == kUndefined) return b;
    if (b == kUndefined) return a;
    if (is_float(a) && is_float(b)) return a >= b ? a : b;
    if (is_float(a) || is_float(b)) return is_float(a) ? a : b;
    if (is_uint(a) && is_uint(b)) return a >= b ? a : b;
    if (is_uint(a) || is_uint(b)) return is_uint(a) ? b : a;
    return a >= b ? a : b;
}

KF_EXPORT int8_t kf_accumulate_type(int8_t t) {
    if (t == kHalf || t == kBFloat16 || t == kFloat) return kFloat;
    if (t == kDouble) return kDouble;
    if (t == kBool) return kBool;
    return kLong;
}

// ---------------------------------------------------------------------------
// Iterator planning: broadcast -> per-operand 0-stride expansion ->
// stride-sorted dim reordering -> adjacent-dim coalescing.
// (reference tensor_iterator.cpp:110-147, :149-179, :181-244, :263-307)
// ---------------------------------------------------------------------------

KF_EXPORT int kf_broadcast_shapes(int ntensors, const int64_t *ndims,
                                  const int64_t *shapes_flat, int64_t *out_ndim,
                                  int64_t *out_shape /* size >= max ndim */) {
    int64_t max_nd = 0;
    for (int t = 0; t < ntensors; t++) max_nd = std::max(max_nd, ndims[t]);
    std::vector<int64_t> out(max_nd, 1);
    const int64_t *p = shapes_flat;
    for (int t = 0; t < ntensors; t++) {
        int64_t nd = ndims[t];
        for (int64_t i = 0; i < nd; i++) {
            int64_t v = p[i];
            int64_t j = max_nd - nd + i;
            if (v != 1) {
                if (out[j] != 1 && out[j] != v) return -1; // mismatch
                out[j] = v;
            }
        }
        p += nd;
    }
    *out_ndim = max_nd;
    std::copy(out.begin(), out.end(), out_shape);
    return 0;
}

// Plans the loop nest for `ntensors` operands already broadcast to a common
// `ndim`-d shape. strides_flat: ntensors * ndim element strides where
// broadcast dims carry stride 0. Writes the reordered+coalesced shape and
// per-operand strides; returns the coalesced rank.
//
// out_perm (nullable, int64[ndim]): the dim permutation applied before
// coalescing — out dim i came from input dim out_perm[i] (slowest first).
// out_group_sizes (nullable, int64[rank]): how many permuted dims were
// merged into each coalesced dim, in order; sums to ndim.  Together these
// let a consumer (the strided-view gather engine, core/materialize.py)
// reconstruct the logical view from a gather over the coalesced dims:
// gather(cshape) -> reshape(permuted shape) -> transpose(inverse perm).
KF_EXPORT int kf_plan_loop_nest(int ntensors, int64_t ndim,
                                const int64_t *shape,
                                const int64_t *strides_flat,
                                int64_t *out_shape,
                                int64_t *out_strides_flat,
                                int64_t *out_perm,
                                int64_t *out_group_sizes) {
    if (ndim == 0) return 0;
    std::vector<int64_t> shp(shape, shape + ndim);
    std::vector<std::vector<int64_t>> str(ntensors);
    for (int t = 0; t < ntensors; t++)
        str[t].assign(strides_flat + t * ndim, strides_flat + (t + 1) * ndim);

    // 1. reorder dims so that operand-0's strides descend (front = slowest),
    //    ties broken by later operands — mirrors reorder_dimensions which
    //    sorts so the innermost (last) dim has the smallest stride.
    std::vector<int64_t> perm(ndim);
    for (int64_t i = 0; i < ndim; i++) perm[i] = i;
    auto should_swap = [&](int64_t d0, int64_t d1) {
        // returns true if d0 should come before d1 (d0 outer, larger stride)
        for (int t = 0; t < ntensors; t++) {
            int64_t s0 = str[t][d0], s1 = str[t][d1];
            if (s0 == 0 || s1 == 0) continue;
            if (s0 != s1) return s0 > s1;
            if (shp[d0] != shp[d1]) return shp[d0] > shp[d1];
        }
        return false;
    };
    std::stable_sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
        if (a == b) return false;
        return should_swap(a, b);
    });
    std::vector<int64_t> nshp(ndim);
    std::vector<std::vector<int64_t>> nstr(ntensors, std::vector<int64_t>(ndim));
    for (int64_t i = 0; i < ndim; i++) {
        nshp[i] = shp[perm[i]];
        for (int t = 0; t < ntensors; t++) nstr[t][i] = str[t][perm[i]];
    }

    // 2. coalesce adjacent dims where, for every operand,
    //    stride[d] == stride[d+1] * shape[d+1]  (or the dim is size-1).
    std::vector<int64_t> cshape;
    std::vector<int64_t> gsize; // permuted dims merged per coalesced dim
    std::vector<std::vector<int64_t>> cstr(ntensors);
    int64_t cur = 0; // index of current accumulating dim within output
    cshape.push_back(nshp[0]);
    gsize.push_back(1);
    for (int t = 0; t < ntensors; t++) cstr[t].push_back(nstr[t][0]);
    for (int64_t d = 1; d < ndim; d++) {
        // try merging dim d into the current dim
        bool merged = false;
        if (cshape[cur] == 1) {
            cshape[cur] = nshp[d];
            for (int t = 0; t < ntensors; t++) cstr[t][cur] = nstr[t][d];
            merged = true;
        } else if (nshp[d] == 1) {
            merged = true;
        } else {
            // merging means current (outer) absorbs d (inner):
            // combined extent = shape[cur]*shape[d], stride = stride[d];
            // legal iff stride[cur] == stride[d] * shape[d] for every operand.
            bool ok = true;
            for (int t = 0; t < ntensors; t++) {
                if (cstr[t][cur] != nstr[t][d] * nshp[d]) { ok = false; break; }
            }
            if (ok) {
                cshape[cur] *= nshp[d];
                for (int t = 0; t < ntensors; t++) cstr[t][cur] = nstr[t][d];
                merged = true;
            }
        }
        if (!merged) {
            cshape.push_back(nshp[d]);
            gsize.push_back(1);
            for (int t = 0; t < ntensors; t++) cstr[t].push_back(nstr[t][d]);
            cur++;
        } else {
            gsize[cur] += 1;
        }
    }
    int64_t out_nd = (int64_t)cshape.size();
    std::copy(cshape.begin(), cshape.end(), out_shape);
    for (int t = 0; t < ntensors; t++)
        std::copy(cstr[t].begin(), cstr[t].end(), out_strides_flat + t * out_nd);
    if (out_perm) std::copy(perm.begin(), perm.end(), out_perm);
    if (out_group_sizes) std::copy(gsize.begin(), gsize.end(), out_group_sizes);
    return (int)out_nd;
}

// ---------------------------------------------------------------------------
// Autograd tape scheduler (reference tensor.cpp:86-126).
//
// Nodes are grad_fn ids; edges (src -> dst) mean "node src feeds gradient to
// interior node dst".  Pass 1 counts uses; pass 2 emits nodes in the order
// the reference queue would pop them (a node becomes ready only when all of
// its uses have delivered gradients).  Returns the number of scheduled nodes;
// nodes unreachable from the root are not emitted.
// ---------------------------------------------------------------------------

KF_EXPORT int kf_tape_schedule(int64_t n_nodes, int64_t n_edges,
                               const int64_t *edge_src, const int64_t *edge_dst,
                               int64_t root, int64_t *out_order) {
    std::vector<std::vector<int64_t>> children(n_nodes);
    std::vector<int64_t> uses(n_nodes, 0);
    for (int64_t e = 0; e < n_edges; e++) {
        if (edge_src[e] < 0 || edge_src[e] >= n_nodes) return -1;
        if (edge_dst[e] < 0 || edge_dst[e] >= n_nodes) return -1;
        children[edge_src[e]].push_back(edge_dst[e]);
    }
    // pass 1: count uses among nodes reachable from root
    std::vector<char> visited(n_nodes, 0);
    std::vector<int64_t> stack{root};
    visited[root] = 1;
    while (!stack.empty()) {
        int64_t u = stack.back();
        stack.pop_back();
        for (int64_t v : children[u]) {
            uses[v]++;
            if (!visited[v]) {
                visited[v] = 1;
                stack.push_back(v);
            }
        }
    }
    // pass 2: FIFO queue, release child when all uses satisfied
    std::queue<int64_t> q;
    q.push(root);
    int64_t count = 0;
    while (!q.empty()) {
        int64_t u = q.front();
        q.pop();
        out_order[count++] = u;
        for (int64_t v : children[u]) {
            if (--uses[v] == 0) q.push(v);
        }
    }
    return (int)count;
}

// ---------------------------------------------------------------------------
// Serving runtime: KV page allocator + FIFO request queue (green-field; the
// reference has no serving layer).  The page allocator hands out fixed-size
// KV-cache pages from a bounded pool (free-list, LIFO for locality); the
// request queue is the scheduler's admission backbone.  Data (the page pool
// tensors) lives on the card; this is the host-side bookkeeping.
// ---------------------------------------------------------------------------

namespace {

struct PagePool {
    std::vector<int64_t> free_list;
    int64_t total = 0;
};

struct ServeState {
    std::mutex mu;
    int64_t next_pool = 1;
    std::unordered_map<int64_t, PagePool> pools;
    int64_t next_queue = 1;
    std::unordered_map<int64_t, std::queue<int64_t>> queues;
};

ServeState &serve() {
    static ServeState s;
    return s;
}

} // namespace

KF_EXPORT int64_t kf_page_pool_create(int64_t n_pages) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    int64_t id = s.next_pool++;
    PagePool &p = s.pools[id];
    p.total = n_pages;
    p.free_list.reserve(n_pages);
    for (int64_t i = n_pages - 1; i >= 0; i--) p.free_list.push_back(i);
    return id;
}

// Allocates `count` pages into out_pages; returns count, or -1 if the pool
// cannot satisfy the request (nothing is allocated on failure).
KF_EXPORT int64_t kf_page_alloc(int64_t pool_id, int64_t count, int64_t *out_pages) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.pools.find(pool_id);
    if (it == s.pools.end()) return -1;
    PagePool &p = it->second;
    if ((int64_t)p.free_list.size() < count) return -1;
    for (int64_t i = 0; i < count; i++) {
        out_pages[i] = p.free_list.back();
        p.free_list.pop_back();
    }
    return count;
}

KF_EXPORT int64_t kf_page_free(int64_t pool_id, int64_t count, const int64_t *pages) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.pools.find(pool_id);
    if (it == s.pools.end()) return -1;
    for (int64_t i = 0; i < count; i++) it->second.free_list.push_back(pages[i]);
    return count;
}

KF_EXPORT int64_t kf_page_pool_available(int64_t pool_id) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.pools.find(pool_id);
    if (it == s.pools.end()) return -1;
    return (int64_t)it->second.free_list.size();
}

KF_EXPORT int64_t kf_queue_create() {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    int64_t id = s.next_queue++;
    s.queues[id];
    return id;
}

KF_EXPORT int64_t kf_queue_push(int64_t queue_id, int64_t item) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.queues.find(queue_id);
    if (it == s.queues.end()) return -1;
    it->second.push(item);
    return (int64_t)it->second.size();
}

// Pops the oldest item, or returns -1 when empty.
KF_EXPORT int64_t kf_queue_pop(int64_t queue_id) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.queues.find(queue_id);
    if (it == s.queues.end() || it->second.empty()) return -1;
    int64_t item = it->second.front();
    it->second.pop();
    return item;
}

KF_EXPORT int64_t kf_queue_size(int64_t queue_id) {
    ServeState &s = serve();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.queues.find(queue_id);
    if (it == s.queues.end()) return -1;
    return (int64_t)it->second.size();
}

// ---------------------------------------------------------------------------
// Prefix-cache hash index (serving): LRU-ordered map from a 128-bit chained
// prompt-page content hash to a KV page id (green-field; the reference has
// no serving layer).  vLLM-style prefix caching needs, per admitted request,
// one chained hash per full prompt page and a lookup/touch per page; for
// long prompts the Python sha1-per-page loop is the hot host path, so both
// the hashing and the LRU index live here.  128-bit keys keep accidental
// collisions (which would silently share WRONG KV) out of reach; eviction
// policy stays in Python (it consults page refcounts), reading LRU-ordered
// snapshots via kf_pcache_lru.
// ---------------------------------------------------------------------------

namespace {

struct PKey {
    uint64_t a, b;
    bool operator==(const PKey &o) const { return a == o.a && b == o.b; }
};

struct PKeyHash {
    size_t operator()(const PKey &k) const {
        // a, b are already uniform (splitmix-finalized); fold them
        return (size_t)(k.a ^ (k.b * 0x9e3779b97f4a7c15ull));
    }
};

struct PEntry {
    PKey key;
    int64_t page;
    // intrusive LRU list: indices into PCache::nodes (-1 = none)
    int64_t prev = -1, next = -1;
};

struct PCache {
    std::vector<PEntry> nodes;
    std::vector<int64_t> free_nodes;
    std::unordered_map<PKey, int64_t, PKeyHash> map;
    int64_t head = -1;  // oldest
    int64_t tail = -1;  // newest
};

struct PCacheState {
    std::mutex mu;
    int64_t next_id = 1;
    std::unordered_map<int64_t, PCache> caches;
};

PCacheState &pcache_state() {
    static PCacheState s;
    return s;
}

void pc_unlink(PCache &c, int64_t n) {
    PEntry &e = c.nodes[n];
    if (e.prev >= 0) c.nodes[e.prev].next = e.next; else c.head = e.next;
    if (e.next >= 0) c.nodes[e.next].prev = e.prev; else c.tail = e.prev;
    e.prev = e.next = -1;
}

void pc_push_back(PCache &c, int64_t n) {
    PEntry &e = c.nodes[n];
    e.prev = c.tail;
    e.next = -1;
    if (c.tail >= 0) c.nodes[c.tail].next = n; else c.head = n;
    c.tail = n;
}

inline uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

} // namespace

KF_EXPORT int64_t kf_pcache_create() {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    int64_t id = s.next_id++;
    s.caches[id];
    return id;
}

KF_EXPORT void kf_pcache_destroy(int64_t id) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    s.caches.erase(id);
}

// Chained 128-bit content hash per FULL page of `tokens`: page i's key
// commits to the whole token prefix [0, (i+1)*page_size) and to `seed`
// (the LoRA adapter id — identical prompts under different adapters must
// not share KV).  Writes 2 words per page into out_ab (a, b interleaved);
// returns the page count.  out_ab may be null to size the buffer.
KF_EXPORT int64_t kf_pcache_hash_chain(const int32_t *tokens, int64_t n_tokens,
                                       int64_t page_size, int64_t seed,
                                       uint64_t *out_ab) {
    if (page_size <= 0) return 0;
    int64_t n_pages = n_tokens / page_size;
    if (!out_ab) return n_pages;
    uint64_t a = splitmix64((uint64_t)seed ^ 0xa0761d6478bd642full);
    uint64_t b = splitmix64((uint64_t)seed + 0xe7037ed1a0b428dbull);
    for (int64_t p = 0; p < n_pages; p++) {
        for (int64_t i = p * page_size; i < (p + 1) * page_size; i++) {
            uint64_t t = (uint64_t)(uint32_t)tokens[i];
            a = splitmix64(a ^ (t + 0x8bb84b93962eacc9ull));
            b = splitmix64(b + ((a << 29) | (a >> 35)) + t);
        }
        out_ab[2 * p] = a;
        out_ab[2 * p + 1] = b;
    }
    return n_pages;
}

// Lookup WITHOUT touching LRU order; -1 when absent.
KF_EXPORT int64_t kf_pcache_get(int64_t id, uint64_t a, uint64_t b) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    auto mit = it->second.map.find(PKey{a, b});
    return mit == it->second.map.end() ? -1 : it->second.nodes[mit->second].page;
}

// Move an entry to most-recently-used; returns its page or -1.
KF_EXPORT int64_t kf_pcache_touch(int64_t id, uint64_t a, uint64_t b) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    PCache &c = it->second;
    auto mit = c.map.find(PKey{a, b});
    if (mit == c.map.end()) return -1;
    pc_unlink(c, mit->second);
    pc_push_back(c, mit->second);
    return c.nodes[mit->second].page;
}

// Insert at MRU; returns 1 if inserted, 0 if the key was already present
// (existing mapping is left untouched, matching dict.setdefault semantics
// the Python publish loop relies on).
KF_EXPORT int64_t kf_pcache_put(int64_t id, uint64_t a, uint64_t b,
                                int64_t page) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    PCache &c = it->second;
    PKey key{a, b};
    if (c.map.count(key)) return 0;
    int64_t n;
    if (!c.free_nodes.empty()) {
        n = c.free_nodes.back();
        c.free_nodes.pop_back();
    } else {
        n = (int64_t)c.nodes.size();
        c.nodes.emplace_back();
    }
    c.nodes[n] = PEntry{key, page, -1, -1};
    pc_push_back(c, n);
    c.map.emplace(key, n);
    return 1;
}

// Erase; returns the page that was mapped, or -1.
KF_EXPORT int64_t kf_pcache_erase(int64_t id, uint64_t a, uint64_t b) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    PCache &c = it->second;
    auto mit = c.map.find(PKey{a, b});
    if (mit == c.map.end()) return -1;
    int64_t n = mit->second;
    int64_t page = c.nodes[n].page;
    pc_unlink(c, n);
    c.map.erase(mit);
    c.free_nodes.push_back(n);
    return page;
}

KF_EXPORT int64_t kf_pcache_size(int64_t id) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    return (int64_t)it->second.map.size();
}

// Snapshot up to `max` entries in LRU order (oldest first) into out_ab
// (2 words per entry) and out_pages; returns the count written.  The
// eviction scan walks this, checking Python-side page refcounts.
KF_EXPORT int64_t kf_pcache_lru(int64_t id, uint64_t *out_ab,
                                int64_t *out_pages, int64_t max) {
    PCacheState &s = pcache_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.caches.find(id);
    if (it == s.caches.end()) return -1;
    PCache &c = it->second;
    int64_t n = 0;
    for (int64_t cur = c.head; cur >= 0 && n < max; cur = c.nodes[cur].next, n++) {
        out_ab[2 * n] = c.nodes[cur].key.a;
        out_ab[2 * n + 1] = c.nodes[cur].key.b;
        out_pages[n] = c.nodes[cur].page;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Byte-level BPE apply side (models/tokenizer.py).  Token ids 0..255 are the
// raw bytes; every merge (left, right -> result) concatenates two existing
// tokens, so the decoder table is built from the merges alone.  The Python
// trainer makes the merges; this side applies them.
// ---------------------------------------------------------------------------

namespace {

struct BpeModel {
    // (left, right) -> (rank, result); rank = application priority
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> merges;
    std::vector<std::string> token_bytes;  // id -> bytes (0..255 seeded)
    BpeModel() {
        token_bytes.resize(256);
        for (int i = 0; i < 256; i++) token_bytes[i] = std::string(1, (char)i);
    }
};

struct BpeState {
    std::mutex mu;
    int64_t next_id = 1;
    std::unordered_map<int64_t, BpeModel> models;
};

BpeState &bpe_state() {
    static BpeState s;
    return s;
}

inline uint64_t bpe_key(int32_t l, int32_t r) {
    return ((uint64_t)(uint32_t)l << 32) | (uint64_t)(uint32_t)r;
}

} // namespace

KF_EXPORT int64_t kf_bpe_create() {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    int64_t id = s.next_id++;
    s.models[id];
    return id;
}

KF_EXPORT void kf_bpe_destroy(int64_t id) {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    s.models.erase(id);
}

// Register the next merge (ranks are assigned in call order).  `result`
// must be >= 256; left and right must already exist.  Returns the rank, or
// -1 on an invalid argument or a pair already registered.
KF_EXPORT int64_t kf_bpe_add_merge(int64_t id, int32_t left, int32_t right,
                                   int32_t result) {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.models.find(id);
    if (it == s.models.end()) return -1;
    BpeModel &m = it->second;
    if (left < 0 || right < 0 || (size_t)left >= m.token_bytes.size() ||
        (size_t)right >= m.token_bytes.size() || result < 256)
        return -1;
    int32_t rank = (int32_t)m.merges.size();
    if (!m.merges.emplace(bpe_key(left, right),
                          std::make_pair(rank, result)).second)
        return -1;
    if ((size_t)result >= m.token_bytes.size())
        m.token_bytes.resize((size_t)result + 1);
    m.token_bytes[result] = m.token_bytes[left] + m.token_bytes[right];
    return rank;
}

// Encode bytes -> token ids: repeatedly merge every occurrence of the
// lowest-rank adjacent pair, left to right.  out must hold n ids (encoding
// never grows).  Returns the token count, or -1 on an unknown model.
KF_EXPORT int64_t kf_bpe_encode(int64_t id, const uint8_t *text, int64_t n,
                                int32_t *out) {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.models.find(id);
    if (it == s.models.end()) return -1;
    BpeModel &m = it->second;
    std::vector<int32_t> ids(n);
    for (int64_t i = 0; i < n; i++) ids[i] = (int32_t)text[i];
    while (ids.size() >= 2) {
        int32_t best_rank = INT32_MAX;
        for (size_t i = 0; i + 1 < ids.size(); i++) {
            auto f = m.merges.find(bpe_key(ids[i], ids[i + 1]));
            if (f != m.merges.end() && f->second.first < best_rank)
                best_rank = f->second.first;
        }
        if (best_rank == INT32_MAX) break;
        std::vector<int32_t> next;
        next.reserve(ids.size());
        for (size_t i = 0; i < ids.size();) {
            if (i + 1 < ids.size()) {
                auto f = m.merges.find(bpe_key(ids[i], ids[i + 1]));
                if (f != m.merges.end() && f->second.first == best_rank) {
                    next.push_back(f->second.second);
                    i += 2;
                    continue;
                }
            }
            next.push_back(ids[i]);
            i += 1;
        }
        ids.swap(next);
    }
    for (size_t i = 0; i < ids.size(); i++) out[i] = ids[i];
    return (int64_t)ids.size();
}

// Decode token ids -> bytes.  With out == null returns the byte count;
// otherwise writes up to `cap` bytes and returns the byte count.  Returns
// -1 on an unknown model, an id out of range or an id no merge made.
KF_EXPORT int64_t kf_bpe_decode(int64_t id, const int32_t *ids, int64_t n,
                                uint8_t *out, int64_t cap) {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.models.find(id);
    if (it == s.models.end()) return -1;
    BpeModel &m = it->second;
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        if (ids[i] < 0 || (size_t)ids[i] >= m.token_bytes.size()) return -1;
        const std::string &b = m.token_bytes[ids[i]];
        if (b.empty() && ids[i] >= 256) return -1;
        if (out) {
            if (total + (int64_t)b.size() > cap) return -1;
            memcpy(out + total, b.data(), b.size());
        }
        total += (int64_t)b.size();
    }
    return total;
}

KF_EXPORT int64_t kf_bpe_vocab_size(int64_t id) {
    BpeState &s = bpe_state();
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.models.find(id);
    if (it == s.models.end()) return -1;
    return (int64_t)it->second.token_bytes.size();
}

// ---------------------------------------------------------------------------
// A zstd decoder, for utils/orbax_format.py: the checkpoints of orbax's
// StandardCheckpointer are TensorStore OCDBT stores (most manifest and
// B+tree node bodies and every zarr chunk are zstd frames).  Not in the JAX
// package's core, which leaves the format to orbax.
//
// kf_zstd_decompress decodes RFC 8878 frames without a dictionary: raw,
// RLE and compressed blocks; Huffman-coded literals (direct and
// FSE-compressed weights, one or four streams, treeless blocks reusing the
// previous table); FSE-coded sequences in predefined, RLE, FSE-compressed
// and repeat modes; the repeat offsets; the XXH64 content checksum where a
// frame carries one; skippable frames and concatenated frames.
// ---------------------------------------------------------------------------

namespace {

namespace zstd {

struct Error {
    int64_t code;
};
constexpr int64_t kCorrupt = -1, kChecksum = -2, kDictionary = -3,
                  kTruncated = -4;

[[noreturn]] void fail(int64_t code) { throw Error{code}; }

inline uint32_t le16(const uint8_t *p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t *p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t *p) { return le24(p) | ((uint32_t)p[3] << 24); }
inline uint64_t le64(const uint8_t *p) {
    return le32(p) | ((uint64_t)le32(p + 4) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// the output of all frames: the caller's buffer while it holds it, then a
// heap buffer (the caller asks again with a buffer of the returned size)
struct Out {
    uint8_t *dst;
    size_t cap;
    std::vector<uint8_t> heap;
    bool on_heap = false;
    size_t len = 0;
    uint8_t *data() { return on_heap ? heap.data() : dst; }
    void ensure(size_t total) {
        if (!on_heap) {
            if (total <= cap) return;
            heap.resize(std::max(total, 2 * cap + 65536));
            if (len) memcpy(heap.data(), dst, len);
            on_heap = true;
        } else if (heap.size() < total) {
            heap.resize(std::max(total, 2 * heap.size()));
        }
    }
};

// forward bits, least significant first (FSE table descriptions)
struct FwdBits {
    const uint8_t *p;
    size_t n;
    size_t pos = 0;  // in bits
    uint32_t peek(int k) const {
        uint32_t v = 0;
        for (int i = 0; i < k; i++) {
            size_t b = pos + i;
            if (b / 8 < n) v |= ((p[b / 8] >> (b % 8)) & 1u) << i;
        }
        return v;
    }
    void skip(int k) {
        pos += k;
        if ((pos + 7) / 8 > n) fail(kCorrupt);
    }
};

// backward bits (Huffman streams, FSE streams): the last byte's highest
// set bit marks the start; bits are read from there toward the first byte,
// and reading past the first byte gives zeros (pos goes negative)
struct BackBits {
    const uint8_t *p;
    int64_t n;
    int64_t pos;  // bits not yet read
    BackBits(const uint8_t *data, size_t size) : p(data), n((int64_t)size) {
        if (size == 0 || data[size - 1] == 0) fail(kCorrupt);
        pos = (int64_t)(size - 1) * 8 + highbit(data[size - 1]);
    }
    uint64_t peek(int k) const {  // the k bits below pos, zeros past start
        if (k == 0) return 0;
        int64_t lo = pos - k;
        if (lo >= 0 && (lo >> 3) + 8 <= n && k <= 56) {
            uint64_t w;
            memcpy(&w, p + (lo >> 3), 8);  // little-endian hosts
            return (w >> (lo & 7)) & ((1ull << k) - 1);
        }
        uint64_t v = 0;
        int64_t first = lo < 0 ? 0 : lo;
        int64_t shift0 = first - lo;  // zero bits below the stream's start
        int64_t b = first;
        while (b < pos) {
            int64_t byte = b >> 3, bit = b & 7;
            int take = (int)std::min<int64_t>(8 - bit, pos - b);
            uint64_t chunk = (p[byte] >> bit) & ((1u << take) - 1u);
            v |= chunk << (b - first + shift0);
            b += take;
        }
        return v;
    }
    uint64_t read(int k) {
        uint64_t v = peek(k);
        pos -= k;
        return v;
    }
};

struct FseEntry {
    uint16_t symbol;
    uint8_t nbits;
    uint16_t base;
};

struct Fse {
    int log = 0;
    std::vector<FseEntry> table;
};

// normalized counts -> decoding table (RFC 8878 4.1.1)
void fse_build(Fse &t, const int16_t *norm, int n_sym, int log) {
    const int size = 1 << log;
    t.log = log;
    t.table.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(n_sym);
    int high = size - 1;
    for (int s = 0; s < n_sym; s++) {
        if (norm[s] == -1) {
            t.table[high--].symbol = (uint16_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)std::max<int>(norm[s], 0);
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < n_sym; s++)
        for (int i = 0; i < norm[s]; i++) {
            t.table[pos].symbol = (uint16_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    if (pos != 0) fail(kCorrupt);
    for (int u = 0; u < size; u++) {
        const int s = t.table[u].symbol;
        const uint32_t st = next[s]++;
        if (st == 0) fail(kCorrupt);
        const int nb = log - highbit(st);
        t.table[u].nbits = (uint8_t)nb;
        t.table[u].base = (uint16_t)((st << nb) - size);
    }
}

// an FSE table description at p (n bytes available): returns the bytes it
// took
size_t fse_read(Fse &t, const uint8_t *p, size_t n, int max_sym, int max_log) {
    FwdBits bits{p, n};
    const int log = (int)bits.peek(4) + 5;
    bits.skip(4);
    if (log > max_log) fail(kCorrupt);
    int16_t norm[256] = {0};
    int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
    int s = 0;
    while (remaining > 1) {
        if (s > max_sym) fail(kCorrupt);
        const int max = 2 * threshold - 1 - remaining;
        int value;
        const uint32_t low = bits.peek(nb - 1);
        if ((int)low < max) {
            value = (int)low;
            bits.skip(nb - 1);
        } else {
            value = (int)bits.peek(nb);
            if (value >= threshold) value -= max;
            bits.skip(nb);
        }
        const int proba = value - 1;
        remaining -= proba < 0 ? -proba : proba;
        norm[s++] = (int16_t)proba;
        if (proba == 0) {
            for (;;) {  // 2-bit repeat flags of more zero probabilities
                const int rep = (int)bits.peek(2);
                bits.skip(2);
                for (int i = 0; i < rep; i++) {
                    if (s > max_sym) fail(kCorrupt);
                    norm[s++] = 0;
                }
                if (rep != 3) break;
            }
        }
        while (remaining < threshold && nb > 1) {
            nb--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail(kCorrupt);
    fse_build(t, norm, s, log);
    return (bits.pos + 7) / 8;
}

void fse_rle(Fse &t, int symbol) {
    t.log = 0;
    t.table.assign(1, FseEntry{(uint16_t)symbol, 0, 0});
}

struct Huffman {
    int max_bits = 0;
    std::vector<uint8_t> symbol, nbits;  // 1 << max_bits entries
};

// a Huffman tree description; returns the bytes it took
size_t huf_read(Huffman &h, const uint8_t *p, size_t n) {
    if (n < 1) fail(kCorrupt);
    uint8_t w[256] = {0};
    int n_w = 0;
    size_t used;
    const int head = p[0];
    if (head >= 128) {  // direct: 4 bits a weight
        n_w = head - 127;
        used = 1 + (n_w + 1) / 2;
        if (used > n) fail(kCorrupt);
        for (int i = 0; i < n_w; i++)
            w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
    } else {  // FSE-compressed weights: two interleaved states
        used = 1 + (size_t)head;
        if (used > n || head == 0) fail(kCorrupt);
        Fse t;
        const size_t d = fse_read(t, p + 1, head, 255, 6);
        if (d >= (size_t)head) fail(kCorrupt);
        BackBits bits(p + 1 + d, head - d);
        uint32_t s1 = (uint32_t)bits.read(t.log), s2 = (uint32_t)bits.read(t.log);
        auto step = [&](uint32_t &s) {
            const FseEntry &e = t.table[s];
            w[n_w++] = (uint8_t)e.symbol;
            s = e.base + (uint32_t)bits.read(e.nbits);
        };
        for (;;) {
            if (n_w > 253) fail(kCorrupt);
            step(s1);
            if (bits.pos < 0) {
                w[n_w++] = (uint8_t)t.table[s2].symbol;
                break;
            }
            step(s2);
            if (bits.pos < 0) {
                w[n_w++] = (uint8_t)t.table[s1].symbol;
                break;
            }
        }
    }
    // the last weight is implied: the sum of 2^(w-1) fills a power of two
    uint32_t total = 0;
    for (int i = 0; i < n_w; i++) {
        if (w[i] > 11) fail(kCorrupt);
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0 || n_w >= 256) fail(kCorrupt);
    const int max_bits = highbit(total) + 1;
    const uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) fail(kCorrupt);
    w[n_w++] = (uint8_t)(highbit(rest) + 1);
    if (max_bits > 11) fail(kCorrupt);
    h.max_bits = max_bits;
    h.symbol.assign(1u << max_bits, 0);
    h.nbits.assign(1u << max_bits, 0);
    uint32_t pos = 0;
    for (int weight = 1; weight <= max_bits; weight++)
        for (int s = 0; s < n_w; s++) {
            if (w[s] != weight) continue;
            const uint32_t len = 1u << (weight - 1);
            for (uint32_t i = 0; i < len; i++) {
                h.symbol[pos + i] = (uint8_t)s;
                h.nbits[pos + i] = (uint8_t)(max_bits + 1 - weight);
            }
            pos += len;
        }
    if (pos != (1u << max_bits)) fail(kCorrupt);
    return used;
}

void huf_stream(const Huffman &h, const uint8_t *p, size_t n, uint8_t *out,
                size_t count) {
    BackBits bits(p, n);
    const int mb = h.max_bits;
    const uint64_t mask = (1ull << mb) - 1;
    size_t i = 0;
    // the bulk: 57 bits at a time from one 8-byte load
    while (i < count && bits.pos >= 64) {
        const int64_t lo = bits.pos - 57;
        uint64_t w;
        memcpy(&w, p + (lo >> 3), 8);  // little-endian hosts
        w >>= lo & 7;
        int avail = 57;
        while (avail >= mb && i < count) {
            const uint32_t idx = (uint32_t)((w >> (avail - mb)) & mask);
            out[i++] = h.symbol[idx];
            avail -= h.nbits[idx];
        }
        bits.pos = lo + avail;
    }
    for (; i < count; i++) {
        const uint32_t idx = (uint32_t)bits.peek(h.max_bits);
        out[i] = h.symbol[idx];
        bits.pos -= h.nbits[idx];
    }
    if (bits.pos != 0) fail(kCorrupt);
}

// RFC 8878 3.1.1.3.2.1.1: predefined distributions
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1,  1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,    9,
                              10, 11, 12, 13, 14, 15, 16, 18, 20,   22,
                              24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,
                              14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                              25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
                              37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                              259, 515, 1027, 2051, 4099, 8195, 16387,
                              32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// what a frame's blocks carry over from one block to the next
struct State {
    Huffman huf;
    bool have_huf = false;
    Fse ll, of, ml;
    bool have_ll = false, have_of = false, have_ml = false;
    uint32_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lit;
};

size_t read_table(Fse &t, bool &have, int mode, const uint8_t *p, size_t n,
                  const int16_t *def, int n_def, int def_log, int max_sym,
                  int max_log) {
    switch (mode) {
    case 0:
        fse_build(t, def, n_def, def_log);
        have = true;
        return 0;
    case 1:
        if (n < 1 || p[0] > max_sym) fail(kCorrupt);
        fse_rle(t, p[0]);
        have = true;
        return 1;
    case 2:
        have = true;
        return fse_read(t, p, n, max_sym, max_log);
    default:
        if (!have) fail(kCorrupt);
        return 0;
    }
}

void compressed_block(State &st, const uint8_t *p, size_t n, Out &out,
                      size_t frame_start) {
    // literals
    if (n < 1) fail(kCorrupt);
    const int ltype = p[0] & 3, lfmt = (p[0] >> 2) & 3;
    size_t regen, csize = 0, hsize;
    int streams = 1;
    if (ltype < 2) {
        if (lfmt == 0 || lfmt == 2) {
            regen = p[0] >> 3;
            hsize = 1;
        } else if (lfmt == 1) {
            if (n < 2) fail(kCorrupt);
            regen = (p[0] >> 4) + ((size_t)p[1] << 4);
            hsize = 2;
        } else {
            if (n < 3) fail(kCorrupt);
            regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
            hsize = 3;
        }
    } else {
        if (lfmt == 0 || lfmt == 1) {
            if (n < 3) fail(kCorrupt);
            const uint32_t v = le24(p);
            regen = (v >> 4) & 1023;
            csize = (v >> 14) & 1023;
            hsize = 3;
            streams = lfmt == 0 ? 1 : 4;
        } else if (lfmt == 2) {
            if (n < 4) fail(kCorrupt);
            const uint32_t v = le32(p);
            regen = (v >> 4) & 16383;
            csize = (v >> 18) & 16383;
            hsize = 4;
            streams = 4;
        } else {
            if (n < 5) fail(kCorrupt);
            const uint64_t v = le32(p) | ((uint64_t)p[4] << 32);
            regen = (v >> 4) & 262143;
            csize = (v >> 22) & 262143;
            hsize = 5;
            streams = 4;
        }
    }
    if (regen > (1u << 17)) fail(kCorrupt);
    st.lit.resize(regen);
    size_t pos = hsize;
    if (ltype == 0) {
        if (pos + regen > n) fail(kCorrupt);
        if (regen) memcpy(st.lit.data(), p + pos, regen);
        pos += regen;
    } else if (ltype == 1) {
        if (pos + 1 > n) fail(kCorrupt);
        memset(st.lit.data(), p[pos], regen);
        pos += 1;
    } else {
        if (pos + csize > n) fail(kCorrupt);
        const uint8_t *q = p + pos;
        size_t qn = csize;
        if (ltype == 2) {
            const size_t t = huf_read(st.huf, q, qn);
            st.have_huf = true;
            q += t;
            qn -= t;
        } else if (!st.have_huf) {
            fail(kCorrupt);
        }
        if (streams == 1) {
            huf_stream(st.huf, q, qn, st.lit.data(), regen);
        } else {
            if (qn < 6) fail(kCorrupt);
            size_t sz[4] = {le16(q), le16(q + 2), le16(q + 4), 0};
            if (6 + sz[0] + sz[1] + sz[2] > qn) fail(kCorrupt);
            sz[3] = qn - 6 - sz[0] - sz[1] - sz[2];
            const size_t per = (regen + 3) / 4;
            if (3 * per > regen) fail(kCorrupt);
            const uint8_t *s = q + 6;
            for (int i = 0; i < 4; i++) {
                const size_t cnt = i < 3 ? per : regen - 3 * per;
                huf_stream(st.huf, s, sz[i], st.lit.data() + i * per, cnt);
                s += sz[i];
            }
        }
        pos += csize;
    }

    // sequences
    if (pos >= n) fail(kCorrupt);
    size_t n_seq = p[pos++];
    if (n_seq >= 128) {
        if (n_seq == 255) {
            if (pos + 2 > n) fail(kCorrupt);
            n_seq = le16(p + pos) + 0x7F00;
            pos += 2;
        } else {
            if (pos + 1 > n) fail(kCorrupt);
            n_seq = ((n_seq - 128) << 8) + p[pos];
            pos += 1;
        }
    }
    size_t li = 0;  // literals consumed
    if (n_seq > 0) {
        if (pos >= n) fail(kCorrupt);
        const int modes = p[pos++];
        if (modes & 3) fail(kCorrupt);
        pos += read_table(st.ll, st.have_ll, modes >> 6, p + pos, n - pos,
                          kLLDefault, 36, 6, 35, 9);
        pos += read_table(st.of, st.have_of, (modes >> 4) & 3, p + pos,
                          n - pos, kOFDefault, 29, 5, 31, 8);
        pos += read_table(st.ml, st.have_ml, (modes >> 2) & 3, p + pos,
                          n - pos, kMLDefault, 53, 6, 52, 9);
        if (pos >= n) fail(kCorrupt);
        BackBits bits(p + pos, n - pos);
        uint32_t sl = (uint32_t)bits.read(st.ll.log);
        uint32_t so = (uint32_t)bits.read(st.of.log);
        uint32_t sm = (uint32_t)bits.read(st.ml.log);
        for (size_t i = 0; i < n_seq; i++) {
            const int of_code = st.of.table[so].symbol;
            const int ll_code = st.ll.table[sl].symbol;
            const int ml_code = st.ml.table[sm].symbol;
            if (ll_code > 35 || ml_code > 52 || of_code > 31) fail(kCorrupt);
            const uint64_t of_val = (1ull << of_code) + bits.read(of_code);
            const size_t ml = kMLBase[ml_code] + bits.read(kMLBits[ml_code]);
            const size_t ll = kLLBase[ll_code] + bits.read(kLLBits[ll_code]);
            uint64_t offset;
            if (of_val > 3) {
                offset = of_val - 3;
                st.rep[2] = st.rep[1];
                st.rep[1] = st.rep[0];
                st.rep[0] = (uint32_t)offset;
            } else {
                const int idx = (int)of_val - 1 + (ll == 0 ? 1 : 0);
                if (idx == 0) {
                    offset = st.rep[0];
                } else {
                    offset = idx == 3 ? (uint64_t)st.rep[0] - 1 : st.rep[idx];
                    if (offset == 0) fail(kCorrupt);
                    if (idx != 1) st.rep[2] = st.rep[1];
                    st.rep[1] = st.rep[0];
                    st.rep[0] = (uint32_t)offset;
                }
            }
            if (i + 1 < n_seq) {
                const FseEntry el = st.ll.table[sl], em = st.ml.table[sm],
                               eo = st.of.table[so];
                sl = el.base + (uint32_t)bits.read(el.nbits);
                sm = em.base + (uint32_t)bits.read(em.nbits);
                so = eo.base + (uint32_t)bits.read(eo.nbits);
            }
            if (li + ll > st.lit.size()) fail(kCorrupt);
            out.ensure(out.len + ll + ml);
            uint8_t *o = out.data();
            memcpy(o + out.len, st.lit.data() + li, ll);
            li += ll;
            out.len += ll;
            if (offset > out.len - frame_start) fail(kCorrupt);
            const uint8_t *src = o + out.len - offset;
            uint8_t *dst = o + out.len;
            if (offset >= ml) {
                memcpy(dst, src, ml);
            } else {
                for (size_t k = 0; k < ml; k++) dst[k] = src[k];
            }
            out.len += ml;
        }
        if (bits.pos != 0) fail(kCorrupt);
    } else if (pos != n) {
        fail(kCorrupt);
    }
    const size_t rest = st.lit.size() - li;
    out.ensure(out.len + rest);
    if (rest) memcpy(out.data() + out.len, st.lit.data() + li, rest);
    out.len += rest;
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t *p, size_t n) {
    const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
    auto round = [&](uint64_t acc, uint64_t in) {
        return rotl(acc + in * P2, 31) * P1;
    };
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = round(v1, le64(p));
            v2 = round(v2, le64(p + 8));
            v3 = round(v3, le64(p + 16));
            v4 = round(v4, le64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
    } else {
        h = P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ round(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ ((uint64_t)le32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// one frame at p; returns the bytes it took
size_t frame(const uint8_t *p, size_t n, Out &out) {
    if (n < 4) fail(kTruncated);
    const uint32_t magic = le32(p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
        if (n < 8 || 8 + (size_t)le32(p + 4) > n) fail(kTruncated);
        return 8 + le32(p + 4);
    }
    if (magic != 0xFD2FB528u) fail(kCorrupt);
    size_t pos = 4;
    if (pos >= n) fail(kTruncated);
    const int fhd = p[pos++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail(kCorrupt);
    if (!single) pos++;  // the window descriptor: the output is one buffer
    if (pos > n) fail(kTruncated);
    const int did_size = did_flag == 3 ? 4 : did_flag;
    if (pos + did_size > n) fail(kTruncated);
    uint32_t did = 0;
    for (int i = 0; i < did_size; i++) did |= (uint32_t)p[pos + i] << (8 * i);
    if (did != 0) fail(kDictionary);
    pos += did_size;
    const int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
    if (pos + fcs_size > n) fail(kTruncated);
    uint64_t fcs = 0;
    bool has_fcs = fcs_size > 0;
    for (int i = 0; i < fcs_size; i++) fcs |= (uint64_t)p[pos + i] << (8 * i);
    if (fcs_size == 2) fcs += 256;
    pos += fcs_size;
    const size_t start = out.len;
    if (has_fcs) {
        // a block takes at least 4 bytes of input and gives at most 128 KB,
        // so a header that claims more than the rest could give is corrupt;
        // checked before anything is reserved from it
        if (fcs > ((n - pos) / 4 + 1) * (uint64_t(1) << 17)) fail(kCorrupt);
        out.ensure(start + fcs);
    }
    State st;
    for (;;) {
        if (pos + 3 > n) fail(kTruncated);
        const uint32_t bh = le24(p + pos);
        pos += 3;
        const int last = bh & 1, type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        if (type == 0) {
            if (pos + size > n) fail(kTruncated);
            out.ensure(out.len + size);
            if (size) memcpy(out.data() + out.len, p + pos, size);
            out.len += size;
            pos += size;
        } else if (type == 1) {
            if (pos + 1 > n) fail(kTruncated);
            if (size > (1u << 17)) fail(kCorrupt);
            out.ensure(out.len + size);
            memset(out.data() + out.len, p[pos], size);
            out.len += size;
            pos += 1;
        } else if (type == 2) {
            if (pos + size > n) fail(kTruncated);
            if (size > (1u << 17)) fail(kCorrupt);
            compressed_block(st, p + pos, size, out, start);
            pos += size;
        } else {
            fail(kCorrupt);
        }
        if (last) break;
    }
    if (has_fcs && out.len - start != fcs) fail(kCorrupt);
    if (checksum) {
        if (pos + 4 > n) fail(kTruncated);
        const uint64_t h = xxh64(out.data() + start, out.len - start);
        if ((uint32_t)h != le32(p + pos)) fail(kChecksum);
        pos += 4;
    }
    return pos;
}

}  // namespace zstd
}  // namespace

// Decodes the zstd frames of src[0, n).  Returns the decoded size: when it
// is at most `cap`, the bytes are in dst; when larger, dst is left partly
// written and the caller asks again with a buffer of that size.  Negative
// on error: -1 corrupt data, -2 a content checksum that does not match,
// -3 a frame that needs a dictionary, -4 truncated input.
KF_EXPORT int64_t kf_zstd_decompress(const uint8_t *src, int64_t n,
                                     uint8_t *dst, int64_t cap) {
    zstd::Out out;
    out.dst = dst;
    out.cap = cap < 0 ? 0 : (size_t)cap;
    try {
        size_t pos = 0;
        if (n <= 0) zstd::fail(zstd::kTruncated);
        while (pos < (size_t)n) pos += zstd::frame(src + pos, n - pos, out);
    } catch (const zstd::Error &e) {
        return e.code;
    } catch (const std::exception &) {  // bad_alloc, length_error
        return zstd::kCorrupt;
    }
    return (int64_t)out.len;
}
