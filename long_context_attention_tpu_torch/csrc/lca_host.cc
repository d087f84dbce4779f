// Host core of the paged serving scheduler: the page free list and the
// prefix cache's content LRU with refcounts, behind a C ABI (loaded with
// ctypes by serving/native.py; no PyTorch headers, so it builds in a second
// or two with g++).
//
// This is the scheduler's host-side hot path (serving/continuous.py): every
// admission candidate runs a can_take() dry run over the whole pool at
// every block boundary, and every admission changes the free list, the
// refcounts and the content LRU.
//
// Its decisions must equal the Python allocators' bit for bit (page ids,
// hit counts, eviction order: PrefixPageAllocator in serving/prefix_cache.py
// and _PageAllocator in serving/continuous.py), so that the choice of
// runtime never changes what is served. It mirrors their structures:
//   * free list  = LIFO stack (list.pop() / append  <->  pop_back/push_back)
//   * content cache = insertion-ordered dict with move-to-end on reuse
//     (OrderedDict  <->  std::list + index map, splice-to-back)
//   * eviction = oldest cached page with refcount 0 (front-first scan)
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, into the
// repository's build/host/ (serving/native.py).

#include <array>
#include <cstdint>
#include <cstring>
#include <list>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using Key = std::array<uint8_t, 16>;

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t a, b;
    std::memcpy(&a, k.data(), 8);
    std::memcpy(&b, k.data() + 8, 8);
    return static_cast<size_t>(a * 0x9e3779b97f4a7c15ULL ^ b);
  }
};

struct Allocator {
  // shared
  std::vector<int32_t> free_list;                       // LIFO
  std::unordered_map<int32_t, std::vector<int32_t>> rows;
  // prefix mode only
  bool prefix_mode;
  std::unordered_map<int32_t, int32_t> ref;             // page -> refcount
  std::list<std::pair<Key, int32_t>> lru;               // insertion order
  std::unordered_map<Key, std::list<std::pair<Key, int32_t>>::iterator,
                     KeyHash> cache;                    // key -> lru node
  std::unordered_map<int32_t, Key> page_hash;           // page -> key
  int64_t hit_pages = 0;
  int64_t evictions = 0;

  explicit Allocator(int32_t pool_pages, bool prefix) : prefix_mode(prefix) {
    free_list.reserve(pool_pages);
    for (int32_t p = 1; p < pool_pages; ++p) free_list.push_back(p);
  }

  // ---- basic (non-prefix) mode -------------------------------------------

  int64_t available(int32_t bi) const {
    auto it = rows.find(bi);
    return static_cast<int64_t>(free_list.size()) +
           (it == rows.end() ? 0 : static_cast<int64_t>(it->second.size()));
  }

  // returns 0 on success, -1 if the pool cannot satisfy `need`
  int take_basic(int32_t bi, int32_t need, int32_t* out) {
    auto it = rows.find(bi);
    if (it != rows.end()) {
      free_list.insert(free_list.end(), it->second.begin(), it->second.end());
      rows.erase(it);
    }
    if (static_cast<int32_t>(free_list.size()) < need) return -1;
    std::vector<int32_t> pages;
    pages.reserve(need);
    for (int32_t i = 0; i < need; ++i) {
      pages.push_back(free_list.back());
      free_list.pop_back();
    }
    std::memcpy(out, pages.data(), need * sizeof(int32_t));
    rows[bi] = std::move(pages);
    return 0;
  }

  // windowed-decode growth: extend a RUNNING row by `need` fresh pages.
  // returns 0 on success, -1 if the free list cannot satisfy it.
  int take_extra(int32_t bi, int32_t need, int32_t* out) {
    if (static_cast<int32_t>(free_list.size()) < need) return -1;
    auto& row = rows[bi];
    for (int32_t i = 0; i < need; ++i) {
      int32_t p = free_list.back();
      free_list.pop_back();
      row.push_back(p);
      out[i] = p;
    }
    return 0;
  }

  // windowed-decode reclamation: free specific pages of a RUNNING row
  // (they slid behind the window). Mirrors the Python structure exactly:
  // remove the first occurrence from the row list, push onto the free
  // list in the given order (LIFO parity). Returns -1 if any page is not
  // owned by the row (the Python twin raises — both runtimes must fail
  // loudly on a double release, not leak silently). Validation runs on a
  // scratch copy of the row FIRST, committed only when every page
  // resolves, so a caller treating -1 as recoverable never observes a
  // half-released allocator (the Python twin validates the same way).
  int32_t release_pages(int32_t bi, const int32_t* pages, int32_t n) {
    if (n <= 0) return 0;
    auto it = rows.find(bi);
    if (it == rows.end()) return -1;
    std::vector<int32_t> scratch = it->second;
    for (int32_t i = 0; i < n; ++i) {
      bool found = false;
      for (auto rit = scratch.begin(); rit != scratch.end(); ++rit) {
        if (*rit == pages[i]) {
          scratch.erase(rit);
          found = true;
          break;
        }
      }
      if (!found) return -1;
    }
    it->second = std::move(scratch);
    for (int32_t i = 0; i < n; ++i) free_list.push_back(pages[i]);
    return 0;
  }

  // ---- prefix mode ---------------------------------------------------------

  int64_t lookup(const Key* keys, int32_t n) const {
    int64_t hits = 0;
    for (int32_t i = 0; i < n; ++i) {
      if (cache.find(keys[i]) == cache.end()) break;
      ++hits;
    }
    return hits;
  }

  bool can_take(int32_t bi, const Key* keys, int32_t n, int32_t span_pages) {
    // dry-run of take(): releasing row bi, how many pages can be assembled?
    std::unordered_map<int32_t, int32_t> ref2 = ref;
    int64_t freed_to_free = 0;
    auto it = rows.find(bi);
    if (it != rows.end()) {
      for (int32_t p : it->second) {
        if (--ref2[p] == 0 && page_hash.find(p) == page_hash.end())
          ++freed_to_free;
      }
    }
    int64_t hits = lookup(keys, n);
    std::unordered_set<int32_t> hit_set;
    for (int64_t i = 0; i < hits; ++i) hit_set.insert(cache.at(keys[i])->second);
    int64_t evictable = 0;
    for (const auto& node : lru) {
      int32_t p = node.second;
      auto r = ref2.find(p);
      if ((r == ref2.end() || r->second == 0) && !hit_set.count(p))
        ++evictable;
    }
    return static_cast<int64_t>(free_list.size()) + freed_to_free + evictable >=
           static_cast<int64_t>(span_pages) - hits;
  }

  void release_row(int32_t bi) {
    auto it = rows.find(bi);
    if (it == rows.end()) return;
    for (int32_t p : it->second) {
      auto r = ref.find(p);
      if (r == ref.end()) continue;  // invariant violation; never free twice
      if (--(r->second) == 0) {
        ref.erase(r);
        if (page_hash.find(p) == page_hash.end()) free_list.push_back(p);
        // else: stays content-cached (evictable) — the whole point
      }
    }
    rows.erase(it);
  }

  // returns a page, or -1 if the pool is exhausted (caller gates on can_take)
  int32_t alloc_fresh() {
    if (!free_list.empty()) {
      int32_t p = free_list.back();
      free_list.pop_back();
      return p;
    }
    for (auto it = lru.begin(); it != lru.end(); ++it) {
      int32_t p = it->second;
      if (ref.find(p) == ref.end()) {
        cache.erase(it->first);
        page_hash.erase(p);
        lru.erase(it);
        ++evictions;
        return p;
      }
    }
    return -1;
  }

  // returns n_hits >= 0 on success, -1 on pool exhaustion
  int64_t take_prefix(int32_t bi, const Key* keys, int32_t n,
                      int32_t span_pages, int32_t* out_pages) {
    release_row(bi);
    int64_t hits = lookup(keys, n);
    std::vector<int32_t> pages;
    pages.reserve(span_pages);
    for (int64_t i = 0; i < hits; ++i) {
      auto node = cache.at(keys[i]);
      lru.splice(lru.end(), lru, node);  // MRU (OrderedDict.move_to_end)
      int32_t p = node->second;
      ++ref[p];  // value-initialized to 0 on first touch
      pages.push_back(p);
    }
    hit_pages += hits;
    for (int64_t i = hits; i < span_pages; ++i) {
      int32_t p = alloc_fresh();
      if (p < 0) return -1;
      ++ref[p];
      pages.push_back(p);
    }
    std::memcpy(out_pages, pages.data(), span_pages * sizeof(int32_t));
    rows[bi] = std::move(pages);
    return hits;
  }

  void register_pages(const Key* keys, const int32_t* pages, int32_t n) {
    for (int32_t i = 0; i < n; ++i) {
      if (cache.find(keys[i]) != cache.end()) continue;       // key established
      if (page_hash.find(pages[i]) != page_hash.end()) continue;  // page taken
      lru.emplace_back(keys[i], pages[i]);
      cache[keys[i]] = std::prev(lru.end());
      page_hash[pages[i]] = keys[i];
    }
  }
};

Key* as_keys(const uint8_t* raw) {
  return reinterpret_cast<Key*>(const_cast<uint8_t*>(raw));
}

}  // namespace

extern "C" {

void* lca_alloc_new(int32_t pool_pages, int32_t prefix_mode) {
  return new Allocator(pool_pages, prefix_mode != 0);
}

void lca_alloc_free(void* h) { delete static_cast<Allocator*>(h); }

int64_t lca_available(void* h, int32_t bi) {
  return static_cast<Allocator*>(h)->available(bi);
}

int32_t lca_take_extra(void* h, int32_t bi, int32_t need, int32_t* out) {
  return static_cast<Allocator*>(h)->take_extra(bi, need, out);
}

int32_t lca_release_pages(void* h, int32_t bi, const int32_t* pages,
                          int32_t n) {
  return static_cast<Allocator*>(h)->release_pages(bi, pages, n);
}

int32_t lca_take_basic(void* h, int32_t bi, int32_t need, int32_t* out) {
  return static_cast<Allocator*>(h)->take_basic(bi, need, out);
}

int64_t lca_lookup(void* h, const uint8_t* keys, int32_t n) {
  return static_cast<Allocator*>(h)->lookup(as_keys(keys), n);
}

int32_t lca_can_take(void* h, int32_t bi, const uint8_t* keys, int32_t n,
                     int32_t span_pages) {
  return static_cast<Allocator*>(h)->can_take(bi, as_keys(keys), n, span_pages)
             ? 1 : 0;
}

void lca_release_row(void* h, int32_t bi) {
  static_cast<Allocator*>(h)->release_row(bi);
}

int64_t lca_take_prefix(void* h, int32_t bi, const uint8_t* keys, int32_t n,
                        int32_t span_pages, int32_t* out_pages) {
  return static_cast<Allocator*>(h)->take_prefix(bi, as_keys(keys), n,
                                                 span_pages, out_pages);
}

void lca_register(void* h, const uint8_t* keys, const int32_t* pages,
                  int32_t n) {
  static_cast<Allocator*>(h)->register_pages(as_keys(keys), pages, n);
}

int64_t lca_hit_pages(void* h) { return static_cast<Allocator*>(h)->hit_pages; }

int64_t lca_evictions(void* h) { return static_cast<Allocator*>(h)->evictions; }

}  // extern "C"
