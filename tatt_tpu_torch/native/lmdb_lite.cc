// lmdb_lite: a from-scratch reader/bulk-writer for the LMDB file format.
//
// The reference framework stores every dataset in LMDB archives read
// through the C lmdb library (reference dataset/dataset.py:576-582, keys
// "num-samples", "label-%09d", "image_hr-%09d", "image_lr-%09d").  This
// environment has no liblmdb, so this file implements the on-disk format
// directly (LMDB 0.9 data version 1, 4096-byte pages, little-endian):
//
//   page 0/1: meta pages (magic 0xBEEFC0DE); readers pick the one with
//             the higher mm_txnid
//   B+tree:   branch pages (P_BRANCH) of [separator-key -> child pgno],
//             leaf pages (P_LEAF) of [key -> value]; values larger than
//             the node max spill to P_OVERFLOW page chains (F_BIGDATA)
//
// Scope: the subset the reference uses — a single (main) DB, no DUPSORT,
// no nested DBs, read-only access plus one-shot bulk creation.  Files
// written here are readable by stock liblmdb and vice versa.
//
// Exposed as a C ABI consumed via ctypes (tatt_tpu_torch/data/lmdb_lite.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr size_t kPageSize = 4096;
constexpr size_t kPageHdr = 16;
constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_OVERFLOW = 0x04;
constexpr uint16_t P_META = 0x08;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr uint64_t P_INVALID = ~0ull;
// node header: mn_lo, mn_hi, mn_flags, mn_ksize (4x uint16)
constexpr size_t kNodeHdr = 8;
// max in-page node size: (pagesize - hdr) / minkeys(2), even-aligned
constexpr size_t kNodeMax = ((kPageSize - kPageHdr) / 2) & ~1ull;

#pragma pack(push, 1)
struct PageHdr {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  union {
    struct {
      uint16_t lower;
      uint16_t upper;
    } pb;
    uint32_t pages;  // overflow chain length
  } u;
};
static_assert(sizeof(PageHdr) == kPageHdr, "page header must be 16 bytes");

struct Db {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};
static_assert(sizeof(Db) == 48, "MDB_db must be 48 bytes");

struct Meta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  Db dbs[2];  // FREE_DBI, MAIN_DBI
  uint64_t last_pg;
  uint64_t txnid;
};
#pragma pack(pop)

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = kPageSize;  // from mm_dbs[0].md_pad (see ll_open)
  Db main{};

  const uint8_t* page(uint64_t pgno) const { return map + pgno * psize; }
};

struct NodeView {
  const uint8_t* key;
  size_t klen;
  const uint8_t* node;  // node start
};

inline size_t num_keys(const uint8_t* page) {
  const PageHdr* h = reinterpret_cast<const PageHdr*>(page);
  return (h->u.pb.lower - kPageHdr) >> 1;
}

inline const uint8_t* node_at(const uint8_t* page, size_t i) {
  uint16_t off = rd16(page + kPageHdr + 2 * i);
  return page + off;
}

inline uint64_t branch_pgno(const uint8_t* node) {
  uint64_t lo = rd16(node), hi = rd16(node + 2), fl = rd16(node + 4);
  return lo | (hi << 16) | (fl << 32);
}

inline size_t leaf_dsize(const uint8_t* node) {
  return rd16(node) | (size_t(rd16(node + 2)) << 16);
}

inline int cmp_keys(const uint8_t* a, size_t alen, const uint8_t* b,
                    size_t blen) {
  int c = std::memcmp(a, b, std::min(alen, blen));
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

// Find the child to descend into: largest index whose key <= target
// (index 0's key is the implicit minimum).
size_t branch_search(const uint8_t* page, const uint8_t* key, size_t klen) {
  size_t n = num_keys(page);
  size_t lo = 1, hi = n;  // node 0 always qualifies
  size_t ans = 0;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    const uint8_t* nd = node_at(page, mid);
    size_t ksz = rd16(nd + 6);
    int c = cmp_keys(nd + kNodeHdr, ksz, key, klen);
    if (c <= 0) {
      ans = mid;
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return ans;
}

}  // namespace

extern "C" {

void* ll_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)(2 * kPageSize)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* env = new Env;
  env->fd = fd;
  env->map = static_cast<const uint8_t*>(map);
  env->size = st.st_size;

  // Stock liblmdb records the writing system's page size in
  // mm_dbs[0].md_pad (mdb_env_init_meta / mdb_env_read_header); honor it
  // so archives from 8K/16K-page systems parse, and probe meta page 1 at
  // the offset implied by meta page 0 (falling back to our default when
  // meta 0 is torn).
  const Meta* m0 = reinterpret_cast<const Meta*>(env->map + kPageHdr);
  size_t psize = kPageSize;
  if (m0->magic == kMagic && m0->version == kVersion && m0->dbs[0].pad >= 512)
    psize = m0->dbs[0].pad;
  if (st.st_size < (off_t)(2 * psize)) {
    munmap(const_cast<uint8_t*>(env->map), env->size);
    ::close(fd);
    delete env;
    return nullptr;
  }
  env->psize = psize;

  const Meta* best = nullptr;
  for (int i = 0; i < 2; i++) {
    const Meta* m =
        reinterpret_cast<const Meta*>(env->page(i) + kPageHdr);
    if (m->magic != kMagic || m->version != kVersion) continue;
    if (!best || m->txnid > best->txnid) best = m;
  }
  if (!best) {
    munmap(const_cast<uint8_t*>(env->map), env->size);
    ::close(fd);
    delete env;
    return nullptr;
  }
  env->main = best->dbs[1];
  return env;
}

void ll_close(void* h) {
  auto* env = static_cast<Env*>(h);
  if (!env) return;
  if (env->map) munmap(const_cast<uint8_t*>(env->map), env->size);
  if (env->fd >= 0) ::close(env->fd);
  delete env;
}

long long ll_entries(void* h) {
  return static_cast<Env*>(h)->main.entries;
}

// Returns 0 and sets (*out, *olen) on hit; -1 on miss; -2 on corruption.
long long ll_get(void* h, const void* key_, size_t klen, const void** out,
                 size_t* olen) {
  auto* env = static_cast<Env*>(h);
  const uint8_t* key = static_cast<const uint8_t*>(key_);
  if (env->main.root == P_INVALID) return -1;
  const uint8_t* pg = env->page(env->main.root);
  for (;;) {
    const PageHdr* hd = reinterpret_cast<const PageHdr*>(pg);
    if (hd->flags & P_BRANCH) {
      size_t idx = branch_search(pg, key, klen);
      pg = env->page(branch_pgno(node_at(pg, idx)));
    } else if (hd->flags & P_LEAF) {
      size_t n = num_keys(pg);
      size_t lo = 0, hi = n;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        const uint8_t* nd = node_at(pg, mid);
        size_t ksz = rd16(nd + 6);
        int c = cmp_keys(nd + kNodeHdr, ksz, key, klen);
        if (c == 0) {
          uint16_t flags = rd16(nd + 4);
          size_t dsz = leaf_dsize(nd);
          if (flags & F_BIGDATA) {
            uint64_t opg;
            std::memcpy(&opg, nd + kNodeHdr + ksz, 8);
            *out = env->page(opg) + kPageHdr;
          } else {
            *out = nd + kNodeHdr + ksz;
          }
          *olen = dsz;
          return 0;
        }
        if (c < 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      return -1;
    } else {
      return -2;
    }
  }
}

// ---------------------------------------------------------------------
// Bulk writer: builds a fresh data.mdb from n (key, value) pairs.
// ---------------------------------------------------------------------

namespace {

struct PageOut {
  std::vector<uint8_t> bytes;
  PageOut() : bytes(kPageSize, 0) {}
  PageHdr* hdr() { return reinterpret_cast<PageHdr*>(bytes.data()); }
};

struct Builder {
  std::vector<PageOut> pages;  // index == pgno
  Db main{};

  Builder() {
    pages.resize(2);  // metas filled at the end
    main.root = P_INVALID;
  }

  uint64_t alloc(uint16_t flags, uint32_t npages = 1) {
    uint64_t pgno = pages.size();
    for (uint32_t i = 0; i < npages; i++) pages.emplace_back();
    PageHdr* h = pages[pgno].hdr();
    h->pgno = pgno;
    h->flags = flags;
    if (flags & P_OVERFLOW) {
      h->u.pages = npages;
    } else {
      h->u.pb.lower = kPageHdr;
      h->u.pb.upper = kPageSize;
    }
    return pgno;
  }

  // append a node; returns false if it does not fit
  bool add_node(uint64_t pgno, const uint8_t* key, size_t klen,
                const uint8_t* data, size_t dlen, uint16_t nflags,
                uint64_t child_or_ovpg, bool is_branch, size_t dsize_field) {
    PageOut& po = pages[pgno];
    PageHdr* h = po.hdr();
    size_t body = is_branch ? klen : (nflags & F_BIGDATA ? klen + 8 : klen + dlen);
    size_t nsize = (kNodeHdr + body + 1) & ~1ull;  // even-align
    size_t need = nsize + 2;                       // + ptr slot
    if (h->u.pb.upper - h->u.pb.lower < need) return false;
    uint16_t off = h->u.pb.upper - nsize;
    uint8_t* nd = po.bytes.data() + off;
    if (is_branch) {
      uint16_t lo = child_or_ovpg & 0xffff;
      uint16_t hi16 = (child_or_ovpg >> 16) & 0xffff;
      uint16_t fl = (child_or_ovpg >> 32) & 0xffff;
      std::memcpy(nd, &lo, 2);
      std::memcpy(nd + 2, &hi16, 2);
      std::memcpy(nd + 4, &fl, 2);
    } else {
      uint16_t lo = dsize_field & 0xffff;
      uint16_t hi16 = (dsize_field >> 16) & 0xffff;
      std::memcpy(nd, &lo, 2);
      std::memcpy(nd + 2, &hi16, 2);
      std::memcpy(nd + 4, &nflags, 2);
    }
    uint16_t ks = klen;
    std::memcpy(nd + 6, &ks, 2);
    std::memcpy(nd + kNodeHdr, key, klen);
    if (!is_branch) {
      if (nflags & F_BIGDATA) {
        std::memcpy(nd + kNodeHdr + klen, &child_or_ovpg, 8);
      } else if (dlen) {
        std::memcpy(nd + kNodeHdr + klen, data, dlen);
      }
    }
    size_t idx = (h->u.pb.lower - kPageHdr) >> 1;
    uint16_t* ptrs = reinterpret_cast<uint16_t*>(po.bytes.data() + kPageHdr);
    ptrs[idx] = off;
    h->u.pb.lower += 2;
    h->u.pb.upper = off;
    return true;
  }
};

}  // namespace

// keys must be distinct; sorted==0 triggers an internal sort.
// Returns 0 on success.
long long ll_write(const char* path, const uint8_t* const* keys,
                   const size_t* klens, const uint8_t* const* vals,
                   const size_t* vlens, size_t n, int sorted) {
  std::vector<size_t> order(n);
  for (size_t i = 0; i < n; i++) order[i] = i;
  if (!sorted) {
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      return cmp_keys(keys[a], klens[a], keys[b], klens[b]) < 0;
    });
  }

  Builder b;
  struct Sep {
    std::string key;  // lowest key of the page (empty for leftmost)
    uint64_t pgno;
  };
  std::vector<Sep> level;  // current leaf level separators

  uint64_t cur = P_INVALID;
  size_t leaf_count = 0, ov_count = 0;
  for (size_t oi = 0; oi < n; oi++) {
    size_t i = order[oi];
    const uint8_t* key = keys[i];
    size_t klen = klens[i];
    if (klen == 0 || klen > 511) return -3;
    size_t dlen = vlens[i];
    uint16_t nflags = 0;
    uint64_t ovpg = 0;
    size_t inline_dlen = dlen;
    if (kNodeHdr + klen + dlen > kNodeMax) {
      nflags = F_BIGDATA;
      uint32_t npg = (dlen + kPageHdr + kPageSize - 1) / kPageSize;
      ovpg = b.alloc(P_OVERFLOW, npg);
      uint8_t* dst = b.pages[ovpg].bytes.data() + kPageHdr;
      // overflow data is contiguous across the chain
      size_t first = std::min(dlen, kPageSize - kPageHdr);
      std::memcpy(dst, vals[i], first);
      size_t done = first;
      for (uint32_t p = 1; p < npg && done < dlen; p++) {
        size_t chunk = std::min(dlen - done, kPageSize);
        std::memcpy(b.pages[ovpg + p].bytes.data(), vals[i] + done, chunk);
        done += chunk;
      }
      ov_count += npg;
      inline_dlen = 0;
    }
    if (cur == P_INVALID) {
      cur = b.alloc(P_LEAF);
      leaf_count++;
      level.push_back({oi == 0 ? std::string()
                               : std::string((const char*)key, klen),
                       cur});
    }
    if (!b.add_node(cur, key, klen, vals[i], inline_dlen, nflags, ovpg,
                    false, dlen)) {
      cur = b.alloc(P_LEAF);
      leaf_count++;
      level.push_back({std::string((const char*)key, klen), cur});
      if (!b.add_node(cur, key, klen, vals[i], inline_dlen, nflags, ovpg,
                      false, dlen))
        return -4;
    }
  }

  uint16_t depth = 1;
  size_t branch_count = 0;
  while (level.size() > 1) {
    std::vector<Sep> up;
    uint64_t bp = P_INVALID;
    for (size_t i = 0; i < level.size(); i++) {
      bool first_in_page = false;
      if (bp == P_INVALID) {
        bp = b.alloc(P_BRANCH);
        branch_count++;
        up.push_back({level[i].key, bp});
        first_in_page = true;
      }
      const std::string nk = first_in_page ? std::string() : level[i].key;
      if (!b.add_node(bp, (const uint8_t*)nk.data(), nk.size(), nullptr, 0,
                      0, level[i].pgno, true, 0)) {
        bp = b.alloc(P_BRANCH);
        branch_count++;
        up.push_back({level[i].key, bp});
        if (!b.add_node(bp, nullptr, 0, nullptr, 0, 0, level[i].pgno, true,
                        0))
          return -4;
      }
      if (b.pages[bp].hdr()->u.pb.upper - b.pages[bp].hdr()->u.pb.lower <
          kNodeHdr + 64) {
        bp = P_INVALID;  // close page when nearly full
      }
    }
    level = std::move(up);
    depth++;
  }

  b.main.flags = 0;
  b.main.depth = n ? depth : 0;
  b.main.branch_pages = branch_count;
  b.main.leaf_pages = leaf_count;
  b.main.overflow_pages = ov_count;
  b.main.entries = n;
  b.main.root = n ? level[0].pgno : P_INVALID;

  // meta pages: meta0 = empty txn 0, meta1 = committed txn 1 (what stock
  // lmdb produces after the first write transaction)
  for (int m = 0; m < 2; m++) {
    PageHdr* h = b.pages[m].hdr();
    h->pgno = m;
    h->flags = P_META;
    Meta* meta = reinterpret_cast<Meta*>(b.pages[m].bytes.data() + kPageHdr);
    meta->magic = kMagic;
    meta->version = kVersion;
    meta->address = 0;
    meta->mapsize = std::max<uint64_t>(b.pages.size() * kPageSize, 1 << 20);
    meta->dbs[0].flags = 0;
    // stock liblmdb reads the page size from here (mm_dbs[0].md_pad,
    // mdb_env_read_header) — without it our files are MDB_INVALID to it
    meta->dbs[0].pad = kPageSize;
    meta->dbs[0].root = P_INVALID;
    meta->dbs[1].root = P_INVALID;
    meta->last_pg = b.pages.size() - 1;
    meta->txnid = 0;
    if (m == 1) {
      meta->dbs[1] = b.main;
      meta->txnid = 1;
    }
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return -5;
  for (auto& p : b.pages) {
    if (std::fwrite(p.bytes.data(), 1, kPageSize, f) != kPageSize) {
      std::fclose(f);
      return -5;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
