// Native HNSW query service binary (reference parity: hnsw_service/main.cpp,
// a C++ executable — SURVEY.md marks C10/C11 "native").
//
// Two modes, like the reference (main.cpp:51-147):
//  - normal:    loads the .adj graph and pulls ALL vectors from the storage
//               service in one bulk transfer at startup; searches in memory
//               (the reference loads the full hnswlib index instead).
//  - optimized: storage/compute split — only the adjacency lives here;
//               vectors are fetched from the storage service during
//               traversal, one *batched* POST per hop rather than the
//               reference's one GET per node (hnsw_graph.cpp:174-212), with
//               the same retry x3 / linear backoff.
//
// A RLIMIT_AS self-cap makes the memory-reduction claim falsifiable
// (reference main.cpp:19-22; default 2GB, --mem_cap_mb to change/0 to drop).
//
// The device serving path remains the Python query_service (device memory
// holds the index; a C++ process cannot own the XLA client) — this binary
// covers the reference's native CPU serving surface.
//
// Endpoints (wire parity with hnsw_service/main.cpp:59-153 and the Python
// frontend): POST /search {"query": [..], "k": int, "ef": int,
// "entry_id": int} -> {"results": [{"id","distance"}...], "rss_kb", "mode"};
// GET /info; GET /mem.
//
// Usage: hnsw_service --graph g.adj --storage http://127.0.0.1:8081
//        --port 8080 --ef 200 --k 10 --optimized 0|1 --dim 128
//        --mem_cap_mb 2048

#include "httpkit.h"

#include <fcntl.h>
#include <sys/resource.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <mutex>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Adjacency storage, two footprints (the research core of the reference —
// hnsw_service/hnsw_graph.cpp:98-130):
//  - normal:    level-0 lists in RAM as one flat CSR (offsets + pool), no
//               per-list heap objects (a nested vector<vector<...>> costs
//               ~48B of header+slack per node and fragments the heap).
//  - optimized: level-0 lists NOT in RAM at all — only a u64 file offset +
//               degree per node; neighbor lists are pread() from the .adj
//               per visit (reference behavior: record offsets at load,
//               re-read from disk during search, hnsw_graph.cpp:113-130,
//               233-282). Upper levels are tiny (~N/M nodes) and stay in a
//               RAM CSR in both modes.
struct AdjGraph {
  uint32_t entry = 0;
  uint32_t max_level = 0;
  uint32_t n = 0;
  std::vector<int64_t> labels;
  std::vector<uint32_t> node_level;
  // level 0 (normal mode): CSR
  std::vector<uint64_t> l0_off;  // [n+1] into l0_flat
  std::vector<uint32_t> l0_flat;
  // level 0 (optimized mode): lazy file offsets
  std::vector<uint64_t> l0_file_off;  // [n] byte offset of the id list
  std::vector<uint32_t> l0_deg;       // [n]
  int fd = -1;                        // persistent .adj fd (optimized)
  // upper levels (both modes): per-node segment table. up_base[i] indexes
  // up_seg; node i's level-l list (l>=1) is
  // up_flat[up_seg[up_base[i]+l-1] .. up_seg[up_base[i]+l]).
  std::vector<uint64_t> up_base;  // [n+1]
  std::vector<uint64_t> up_seg;   // [sum(node_level)+n] segment starts
  std::vector<uint32_t> up_flat;

  const uint32_t* upper(uint32_t node, uint32_t level, uint32_t* deg) const {
    if (level > node_level[node]) {
      *deg = 0;
      return nullptr;
    }
    uint64_t s = up_seg[up_base[node] + level - 1];
    uint64_t e = up_seg[up_base[node] + level];
    *deg = uint32_t(e - s);
    return up_flat.data() + s;
  }
  const uint32_t* level0(uint32_t node, uint32_t* deg) const {
    *deg = uint32_t(l0_off[node + 1] - l0_off[node]);
    return l0_flat.data() + l0_off[node];
  }
  // optimized mode: fetch node's level-0 ids from disk into `buf`
  bool level0_lazy(uint32_t node, std::vector<uint32_t>* buf) const {
    buf->resize(l0_deg[node]);
    if (!l0_deg[node]) return true;
    ssize_t want = ssize_t(l0_deg[node]) * 4;
    return pread(fd, buf->data(), size_t(want),
                 off_t(l0_file_off[node])) == want;
  }
};

bool load_adj(const char* path, AdjGraph* g, bool lazy_level0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint32_t hdr[3];
  if (fread(hdr, 4, 3, f) != 3) return fclose(f), false;
  g->entry = hdr[0];
  g->max_level = hdr[1];
  g->n = hdr[2];
  g->labels.resize(g->n);
  g->node_level.resize(g->n);
  g->up_base.resize(g->n + 1, 0);
  if (lazy_level0) {
    g->l0_file_off.resize(g->n);
    g->l0_deg.resize(g->n);
  } else {
    g->l0_off.resize(g->n + 1, 0);
  }
  std::vector<uint32_t> tmp;
  for (uint32_t i = 0; i < g->n; ++i) {
    uint32_t head[2];
    if (fread(head, 4, 2, f) != 2) return fclose(f), false;
    g->labels[i] = int64_t(head[0]);
    uint32_t levels = head[1];
    g->node_level[i] = levels - 1;
    g->up_base[i + 1] = g->up_base[i] + levels;  // node_level + 1 boundaries
    g->up_seg.push_back(uint64_t(g->up_flat.size()));  // boundary l=1 start
    for (uint32_t l = 0; l < levels; ++l) {
      uint32_t deg;
      if (fread(&deg, 4, 1, f) != 1) return fclose(f), false;
      if (l == 0) {
        if (lazy_level0) {
          g->l0_file_off[i] = uint64_t(ftello(f));
          g->l0_deg[i] = deg;
          if (fseeko(f, off_t(deg) * 4, SEEK_CUR) != 0)
            return fclose(f), false;
        } else {
          tmp.resize(deg);
          if (deg && fread(tmp.data(), 4, deg, f) != deg)
            return fclose(f), false;
          g->l0_off[i + 1] = g->l0_off[i] + deg;
          g->l0_flat.insert(g->l0_flat.end(), tmp.begin(), tmp.end());
        }
        continue;
      }
      tmp.resize(deg);
      if (deg && fread(tmp.data(), 4, deg, f) != deg) return fclose(f), false;
      g->up_flat.insert(g->up_flat.end(), tmp.begin(), tmp.end());
      g->up_seg.push_back(uint64_t(g->up_flat.size()));  // boundary after l
    }
  }
  fclose(f);
  g->up_flat.shrink_to_fit();
  g->l0_flat.shrink_to_fit();
  g->up_seg.shrink_to_fit();
  if (lazy_level0) {
    g->fd = open(path, O_RDONLY);
    if (g->fd < 0) return false;
  }
  return true;
}

inline float l2_sq(const float* a, const float* b, int dim) {
  float acc = 0.f;
  for (int i = 0; i < dim; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

struct Cand {
  float dist;
  uint32_t id;
};
struct Closer {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist > b.dist; }
};
struct Farther {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist < b.dist; }
};

// Vector source: local table (normal mode) or remote fetch-through cache
// (optimized mode; reference C11's fetch_vector with retry x3,
// hnsw_graph.cpp:184-209, but batched per hop).
struct VecSource {
  int dim = 0;
  bool remote = false;
  std::vector<float> table;          // [n, dim] (normal mode)
  std::string host;
  int port = 0;
  std::unordered_map<uint32_t, std::vector<float>> cache;
  std::mutex mu;
  size_t cache_cap = 4096;  // bounded: keeps optimized-mode RSS low

  const float* get_local(uint32_t id) const {
    return table.data() + size_t(id) * dim;
  }

  // ensure ids are present in cache (one batched POST, retry x3)
  bool prefetch(const std::vector<uint32_t>& ids) {
    std::string body = "[";
    bool any = false;
    {
      std::lock_guard<std::mutex> g(mu);
      for (uint32_t id : ids) {
        if (cache.count(id)) continue;
        if (any) body += ",";
        body += std::to_string(id);
        any = true;
      }
    }
    if (!any) return true;
    body += "]";
    std::string out;
    for (int attempt = 0; attempt < 3; ++attempt) {
      if (httpkit::request(host, port, "POST", "/vec/batch_get", body, &out))
        break;
      if (attempt == 2) return false;
      usleep(useconds_t(200000 * (attempt + 1)));  // linear backoff
    }
    // parse [[floats]|null, ...] positionally against the requested ids
    std::vector<uint32_t> want;
    {
      std::lock_guard<std::mutex> g(mu);
      for (uint32_t id : ids)
        if (!cache.count(id)) want.push_back(id);
    }
    const char* p = out.c_str();
    while (*p && *p != '[') ++p;
    if (*p) ++p;
    size_t wi = 0;
    std::lock_guard<std::mutex> g(mu);
    // evict BEFORE inserting the batch: clearing mid-batch (old behavior)
    // wiped vectors prefetched earlier in this same hop, silently skipping
    // neighbors (a deterministic -0.5% recall at N=50k)
    if (cache.size() + want.size() > cache_cap) cache.clear();
    while (*p && wi < want.size()) {
      while (*p && (isspace((unsigned char)*p) || *p == ',')) ++p;
      if (*p == ']') break;
      if (strncmp(p, "null", 4) == 0) {
        p += 4;
        ++wi;
        continue;
      }
      if (*p != '[') break;
      std::vector<float> v;
      if (!httpkit::json_parse_floats(p, &v)) break;
      // advance past this array
      int depth = 0;
      while (*p) {
        if (*p == '[') ++depth;
        if (*p == ']' && --depth == 0) {
          ++p;
          break;
        }
        ++p;
      }
      if (int(v.size()) == dim) {
        cache.emplace(want[wi], std::move(v));
      }
      ++wi;
    }
    return true;
  }

  const float* get(uint32_t id) {
    if (!remote) return get_local(id);
    std::lock_guard<std::mutex> g(mu);
    auto it = cache.find(id);
    return it == cache.end() ? nullptr : it->second.data();
  }
};

struct Engine {
  AdjGraph g;
  VecSource vs;
  int default_k = 10, default_ef = 200;
  bool optimized = false;

  // searchKnn semantics (hnswalg.h:1271-1324) over the .adj lists.
  std::vector<Cand> search(const float* q, int k, int ef, long entry_override) {
    uint32_t ep = g.entry;
    if (entry_override >= 0 && uint32_t(entry_override) < g.n)
      ep = uint32_t(entry_override);
    if (g.n == 0) return {};
    if (optimized) vs.prefetch({ep});
    const float* epv = vs.get(ep);
    if (!epv) return {};
    float ep_d = l2_sq(q, epv, vs.dim);

    // greedy upper descent (upper lists are in the RAM CSR in both modes)
    std::vector<uint32_t> nb_vec;
    for (uint32_t l = g.max_level; l >= 1; --l) {
      bool changed = true;
      while (changed) {
        changed = false;
        if (g.node_level[ep] < l) break;
        uint32_t deg = 0;
        const uint32_t* nb = g.upper(ep, l, &deg);
        if (optimized && deg)
          vs.prefetch(std::vector<uint32_t>(nb, nb + deg));
        for (uint32_t j = 0; j < deg; ++j) {
          uint32_t cand = nb[j];
          const float* cv = vs.get(cand);
          if (!cv) continue;  // skip-on-error (hnsw_graph.cpp:329-331)
          float d = l2_sq(q, cv, vs.dim);
          if (d < ep_d) {
            ep_d = d;
            ep = cand;
            changed = true;
          }
        }
      }
    }

    // level-0 beam. Optimized mode re-reads each visited node's neighbor
    // list from the .adj file (pread at its recorded offset) — level-0
    // adjacency costs 12B/node of RAM, not the full list pool
    // (hnsw_graph.cpp:233-282 lazy design).
    std::priority_queue<Cand, std::vector<Cand>, Closer> candidates;
    std::priority_queue<Cand, std::vector<Cand>, Farther> results;
    std::vector<uint8_t> visited(g.n, 0);
    visited[ep] = 1;
    candidates.push({ep_d, ep});
    results.push({ep_d, ep});
    float lower = ep_d;
    size_t ef_s = size_t(std::max(ef, k));
    std::vector<uint32_t> fresh;
    while (!candidates.empty()) {
      Cand c = candidates.top();
      if (c.dist > lower && results.size() >= ef_s) break;
      candidates.pop();
      const uint32_t* nb;
      uint32_t deg = 0;
      if (optimized) {
        if (!g.level0_lazy(c.id, &nb_vec)) continue;  // skip-on-error
        nb = nb_vec.data();
        deg = uint32_t(nb_vec.size());
      } else {
        nb = g.level0(c.id, &deg);
      }
      fresh.clear();
      for (uint32_t j = 0; j < deg; ++j)
        if (!visited[nb[j]]) fresh.push_back(nb[j]);
      if (optimized && !fresh.empty()) vs.prefetch(fresh);
      for (uint32_t cand : fresh) {
        visited[cand] = 1;
        const float* cv = vs.get(cand);
        if (!cv) continue;
        float d = l2_sq(q, cv, vs.dim);
        if (results.size() < ef_s || d < lower) {
          candidates.push({d, cand});
          results.push({d, cand});
          if (results.size() > ef_s) results.pop();
          if (results.size() >= ef_s) lower = results.top().dist;
        }
      }
    }
    std::vector<Cand> out;
    while (!results.empty()) {
      out.push_back(results.top());
      results.pop();
    }
    std::reverse(out.begin(), out.end());
    if (int(out.size()) > k) out.resize(size_t(k));
    return out;
  }
};

bool parse_host_port(const std::string& url, std::string* host, int* port) {
  std::string s = url;
  size_t p = s.find("://");
  if (p != std::string::npos) s = s.substr(p + 3);
  p = s.find(':');
  if (p == std::string::npos) return false;
  *host = s.substr(0, p);
  *port = atoi(s.c_str() + p + 1);
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  std::string graph = "./hnsw_index.adj";
  std::string storage = "http://127.0.0.1:8081";
  int port = 8080, ef = 200, k = 10, dim = 128;
  long mem_cap_mb = 2048;
  bool optimized = false;
  for (int i = 1; i + 1 < argc; i += 2) {
    std::string a = argv[i];
    if (a == "--graph") graph = argv[i + 1];
    else if (a == "--storage") storage = argv[i + 1];
    else if (a == "--port") port = atoi(argv[i + 1]);
    else if (a == "--ef") ef = atoi(argv[i + 1]);
    else if (a == "--k") k = atoi(argv[i + 1]);
    else if (a == "--dim") dim = atoi(argv[i + 1]);
    else if (a == "--mem_cap_mb") mem_cap_mb = atol(argv[i + 1]);
    else if (a == "--optimized")
      optimized = std::string(argv[i + 1]) == "1" ||
                  std::string(argv[i + 1]) == "true";
  }

  if (mem_cap_mb > 0) {
    // reference hnsw_service/main.cpp:19-22: deterministic OOM envelope
    rlimit lim{rlim_t(mem_cap_mb) << 20, rlim_t(mem_cap_mb) << 20};
    setrlimit(RLIMIT_AS, &lim);
  }

  auto* eng = new Engine();
  eng->default_k = k;
  eng->default_ef = ef;
  eng->optimized = optimized;
  eng->vs.dim = dim;
  if (!load_adj(graph.c_str(), &eng->g, /*lazy_level0=*/optimized)) {
    fprintf(stderr, "cannot load graph %s\n", graph.c_str());
    return 1;
  }
  std::string host;
  int sport = 0;
  if (!parse_host_port(storage, &host, &sport)) {
    fprintf(stderr, "bad storage url %s\n", storage.c_str());
    return 1;
  }
  eng->vs.host = host;
  eng->vs.port = sport;
  eng->vs.remote = optimized;

  if (!optimized) {
    // one bulk transfer, retry x3 with linear backoff
    std::string out;
    bool ok = false;
    // startup bulk fetch: retry longer than the reference's per-vector x3
    // (the storage service may still be coming up; capped linear backoff)
    for (int attempt = 0; attempt < 15; ++attempt) {
      if ((ok = httpkit::request(host, sport, "GET",
                                 "/vec/bulk?dim=" + std::to_string(dim), "",
                                 &out, 300)))
        break;
      usleep(useconds_t(std::min(1000000 * (attempt + 1), 2000000)));
    }
    if (!ok || out.size() < 8) {
      fprintf(stderr, "bulk vector fetch failed\n");
      return 1;
    }
    uint32_t count, d;
    memcpy(&count, out.data(), 4);
    memcpy(&d, out.data() + 4, 4);
    if (int(d) != dim) {
      fprintf(stderr, "dim mismatch\n");
      return 1;
    }
    // storage ids are labels; map onto internal order
    std::unordered_map<int64_t, uint32_t> label_to_id;
    for (uint32_t i = 0; i < eng->g.n; ++i)
      label_to_id[eng->g.labels[i]] = i;
    eng->vs.table.assign(size_t(eng->g.n) * dim, 0.f);
    size_t rec = 4 + size_t(dim) * 4;
    for (uint32_t i = 0; i < count; ++i) {
      const char* p = out.data() + 8 + size_t(i) * rec;
      uint32_t sid;
      memcpy(&sid, p, 4);
      auto it = label_to_id.find(int64_t(sid));
      if (it == label_to_id.end()) continue;
      memcpy(eng->vs.table.data() + size_t(it->second) * dim, p + 4,
             size_t(dim) * 4);
    }
  }

  httpkit::Server srv;
  srv.route("POST", "/search", [eng](const httpkit::Request& req,
                                     httpkit::Response& resp) {
    const char* qp = httpkit::json_find_key(req.body, "query");
    std::vector<float> q;
    if (!qp || !httpkit::json_parse_floats(qp, &q) ||
        int(q.size()) != eng->vs.dim) {
      resp.status = 400;
      resp.body = "{\"error\": \"bad query\"}";
      return;
    }
    int k = int(httpkit::json_long(req.body, "k", eng->default_k));
    int ef = int(httpkit::json_long(req.body, "ef", eng->default_ef));
    long entry = httpkit::json_long(req.body, "entry_id", -1);
    auto res = eng->search(q.data(), k, ef, entry);
    std::string out = "{\"results\": [";
    char num[64];
    for (size_t i = 0; i < res.size(); ++i) {
      snprintf(num, sizeof(num), "%s{\"id\": %lld, \"distance\": %.9g}",
               i ? "," : "", (long long)eng->g.labels[res[i].id],
               double(res[i].dist));
      out += num;
    }
    out += "], \"rss_kb\": " + std::to_string(httpkit::self_rss_kb());
    if (eng->optimized) out += ", \"mode\": \"optimized\"";
    out += "}";
    resp.body = std::move(out);
  });

  srv.route("GET", "/info", [eng](const httpkit::Request&,
                                  httpkit::Response& resp) {
    resp.body = "{\"nodes\": " + std::to_string(eng->g.n) +
                ", \"dim\": " + std::to_string(eng->vs.dim) +
                ", \"ef\": " + std::to_string(eng->default_ef) +
                ", \"mode\": \"" +
                (eng->optimized ? "optimized" : "normal") + "\"}";
  });

  srv.route("GET", "/mem", [](const httpkit::Request&,
                              httpkit::Response& resp) {
    resp.body = "{\"rss_kb\": " + std::to_string(httpkit::self_rss_kb()) + "}";
  });

  printf("hnsw query service (native, %s) listening on port %d\n",
         optimized ? "optimized" : "normal", port);
  fflush(stdout);
  if (!srv.listen_and_serve(port)) {
    fprintf(stderr, "bind/listen failed on %d\n", port);
    return 1;
  }
  return 0;
}
