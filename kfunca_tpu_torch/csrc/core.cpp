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
