// reference_pipeline: an honest single-threaded CPU reference-class
// implementation of the pairwise whole-genome alignment config
// (BASELINE.md config 1), used to MEASURE the baseline that bench.py's
// vs_baseline is computed against (the reference binaries cannot be built:
// libMems is absent from the snapshot).
//
// It mirrors the reference pipeline's structure (mauveAligner
// doAlignment, /root/reference/src/mauveAligner.cpp:70,668-744) at the
// algorithmic level, implemented lean and cache-friendly:
//   1. sorted spaced-mer lists (SML build; DNAFileSML analog)
//   2. unique-MUM enumeration by sorted-list merge + maximal extension
//      (MaskedMemHash::FindMatches analog)
//   3. collinear anchor chaining (greedy breakpoint elimination analog,
//      pairwise collinear case)
//   4. full Gotoh affine-gap DP with traceback per inter-anchor gap
//      (the MUSCLE-subprocess closure analog — plain DP here, which is
//      FASTER than forking muscle_aed per gap, so this baseline is a
//      conservative LOWER bound on the reference's wall-clock)
//
// Omitted relative to the reference: recursive re-anchoring of large gaps
// and LCB extension (both add reference work, also conservative).
//
// Usage: reference_pipeline <pattern> <codesA.raw> <codesB.raw>
//   pattern: spaced-seed pattern string, e.g. 1101...
//   codes files: one byte per base, values 0..4 (4 = N)
// Prints one JSON line with per-phase seconds and work counters.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <functional>
#include <cmath>
#include <vector>

#include <sys/wait.h>
#include <unistd.h>

using i64 = int64_t;
using u64 = uint64_t;

static std::vector<uint8_t> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != (size_t)n) { fclose(f); exit(1); }
  fclose(f);
  return buf;
}

static double secs(std::chrono::steady_clock::time_point a,
                   std::chrono::steady_clock::time_point b) {
  return std::chrono::duration<double>(b - a).count();
}

struct Entry { u64 key; int32_t pos; };  // key = (canonical << 1) | rc_bit

// K1 analog: pack canonical spaced mers and sort.
static void build_sml(const std::vector<uint8_t>& codes,
                      const std::vector<int>& offs, int L,
                      std::vector<Entry>& out) {
  int w = (int)offs.size();
  i64 n_pos = (i64)codes.size() - L + 1;
  out.clear();
  out.reserve(n_pos > 0 ? n_pos : 0);
  for (i64 p = 0; p < n_pos; p++) {
    u64 fwd = 0, rc = 0;
    bool ok = true;
    for (int j = 0; j < w; j++) {
      int c = codes[p + offs[j]];
      if (c >= 4) { ok = false; break; }
      fwd |= (u64)c << (2 * (w - 1 - j));
      rc |= (u64)(3 - c) << (2 * j);
    }
    if (!ok) continue;
    u64 canonical = rc < fwd ? rc : fwd;
    out.push_back({(canonical << 1) | (u64)(rc < fwd), (int32_t)p});
  }
  std::sort(out.begin(), out.end(), [](const Entry& a, const Entry& b) {
    return a.key != b.key ? a.key < b.key : a.pos < b.pos;
  });
}

struct Match { i64 a_left0; i64 b_left0; i64 len; bool rev; };

// K2 analog: merge the two sorted lists, keep mers unique in BOTH genomes,
// extend each seed to base-level maximality; per-diagonal coverage skips
// re-extension of seeds inside an already-found match.
//
// extend_all disables the coverage skip (oracle mode): a spaced-seed window
// whose span bridges a mismatch at a DON'T-CARE offset extends further than
// the exact match preceding it on the same diagonal — the inexact-match
// semantics libMems' spaced-seed extension has (and the device K2 reproduces);
// the skip would wrongly drop those.  Contained duplicates die in chain()'s
// overlap cropping.  Measurement mode keeps the skip (strictly faster, so
// the measured baseline stays a conservative lower bound).
static void find_mums(const std::vector<uint8_t>& A, const std::vector<uint8_t>& B,
                      const std::vector<Entry>& sa, const std::vector<Entry>& sb,
                      int L, std::vector<Match>& out, bool extend_all = false) {
  struct Seed { i64 pa, pb; bool rev; };
  std::vector<Seed> seeds;
  size_t i = 0, j = 0;
  while (i < sa.size() && j < sb.size()) {
    u64 ma = sa[i].key >> 1, mb = sb[j].key >> 1;
    if (ma < mb) { i++; continue; }
    if (mb < ma) { j++; continue; }
    size_t i2 = i + 1, j2 = j + 1;
    while (i2 < sa.size() && (sa[i2].key >> 1) == ma) i2++;
    while (j2 < sb.size() && (sb[j2].key >> 1) == mb) j2++;
    if (i2 - i == 1 && j2 - j == 1)  // unique in both genomes
      seeds.push_back({sa[i].pos, sb[j].pos,
                       ((sa[i].key ^ sb[j].key) & 1) != 0});
    i = i2; j = j2;
  }
  // group by diagonal so covered seeds skip extension
  std::sort(seeds.begin(), seeds.end(), [](const Seed& x, const Seed& y) {
    i64 dx = x.rev ? x.pa + x.pb : x.pb - x.pa;
    i64 dy = y.rev ? y.pa + y.pb : y.pb - y.pa;
    if (x.rev != y.rev) return x.rev < y.rev;
    if (dx != dy) return dx < dy;
    return x.pa < y.pa;
  });
  i64 prev_diag = INT64_MIN, covered_to = INT64_MIN;
  bool prev_rev = false;
  i64 na = A.size(), nb = B.size();
  for (const Seed& s : seeds) {
    i64 diag = s.rev ? s.pa + s.pb : s.pb - s.pa;
    if (s.rev != prev_rev || diag != prev_diag) covered_to = INT64_MIN;
    prev_rev = s.rev; prev_diag = diag;
    if (!extend_all && s.pa < covered_to) continue;
    // extend: A[a0 + c], fwd B[b0 + c], rev B reads b_right - c complemented
    i64 a0 = s.pa, alen = L;
    i64 b0 = s.pb;  // leftmost of the B window either way
    // left extension
    for (;;) {
      i64 ia = a0 - 1;
      i64 ib = s.rev ? b0 + alen : b0 - 1;
      if (ia < 0 || ib < 0 || ib >= nb) break;
      int ca = A[ia]; if (ca >= 4) break;
      int cb = B[ib]; if (cb >= 4) break;
      if (s.rev) cb = 3 - cb;
      if (ca != cb) break;
      a0--; alen++;
      if (!s.rev) b0--;
    }
    // right extension
    for (;;) {
      i64 ia = a0 + alen;
      i64 ib = s.rev ? b0 - 1 : b0 + alen;
      if (ia >= na || ib < 0 || ib >= nb) break;
      int ca = A[ia]; if (ca >= 4) break;
      int cb = B[ib]; if (cb >= 4) break;
      if (s.rev) cb = 3 - cb;
      if (ca != cb) break;
      alen++;
      if (s.rev) b0--;
    }
    out.push_back({a0, b0, alen, s.rev});
    covered_to = a0 + alen;
  }
  // dedup identical extended matches
  std::sort(out.begin(), out.end(), [](const Match& x, const Match& y) {
    if (x.a_left0 != y.a_left0) return x.a_left0 < y.a_left0;
    if (x.b_left0 != y.b_left0) return x.b_left0 < y.b_left0;
    return x.len < y.len;
  });
  out.erase(std::unique(out.begin(), out.end(), [](const Match& x, const Match& y) {
    return x.a_left0 == y.a_left0 && x.b_left0 == y.b_left0 &&
           x.len == y.len && x.rev == y.rev;
  }), out.end());
}

// --- oracle-mode match processing: exact ports of the pipeline's overlap
// elimination and collinear greedy breakpoint elimination, so the emitted
// columns are comparable position-for-position with the JAX pipeline's output. ------

// Crop `amt` match-space columns from the left (consume_left) or right of
// match m.  A is always the forward reference component; B mirrors through
// the rev flag (match-space left = B genome left for fwd, genome right for
// rev — cropping match-left of a rev match leaves b_left0 untouched).
static void crop_match(Match& m, i64 amt, bool match_left) {
  if (amt >= m.len) { m.len = 0; return; }
  if (match_left) {
    m.a_left0 += amt;
    if (!m.rev) m.b_left0 += amt;
  } else {
    if (m.rev) m.b_left0 += amt;
  }
  m.len -= amt;
}

// Canonical row order shared with the JAX pipeline before overlap
// elimination (core/match.MatchList.eliminate_overlaps): |A left|, |B left|,
// signed B start (reverse sorts first), then length — the per-sequence
// stable sorts inside the cascade break |left| ties by row order, so both
// implementations must start from the same order to agree bit-for-bit.
static void canonical_sort(std::vector<Match>& ms) {
  std::sort(ms.begin(), ms.end(), [](const Match& x, const Match& y) {
    if (x.a_left0 != y.a_left0) return x.a_left0 < y.a_left0;
    if (x.b_left0 != y.b_left0) return x.b_left0 < y.b_left0;
    i64 sx = x.rev ? -(x.b_left0 + 1) : (x.b_left0 + 1);
    i64 sy = y.rev ? -(y.b_left0 + 1) : (y.b_left0 + 1);
    if (sx != sy) return sx < sy;
    return x.len < y.len;
  });
}

// EliminateOverlaps_v2 port (core/match.MatchList.eliminate_overlaps): per
// sequence, sort by genome-left; on overlap crop the shorter match (ties:
// the later one); victim-cur crops its genome-left edge, victim-prev its
// genome-right edge; iterate to fixpoint (<= 8 rounds).
static void eliminate_overlaps_v2(std::vector<Match>& ms) {
  for (int iter = 0; iter < 8; iter++) {
    bool changed = false;
    for (int seq = 0; seq < 2; seq++) {
      std::vector<int> order;
      for (int i = 0; i < (int)ms.size(); i++)
        if (ms[i].len > 0) order.push_back(i);
      std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
        i64 lx = seq == 0 ? ms[x].a_left0 : ms[x].b_left0;
        i64 ly = seq == 0 ? ms[y].a_left0 : ms[y].b_left0;
        return lx < ly;
      });
      if (order.size() < 2) continue;
      int prev = order[0];
      for (size_t k = 1; k < order.size(); k++) {
        int cur = order[k];
        auto left = [&](int i) {
          return seq == 0 ? ms[i].a_left0 : ms[i].b_left0;
        };
        i64 prev_r = left(prev) + ms[prev].len - 1;
        i64 cur_l = left(cur);
        if (cur_l <= prev_r && ms[cur].len > 0 && ms[prev].len > 0) {
          i64 overlap = prev_r - cur_l + 1;
          bool victim_is_cur = !(ms[prev].len < ms[cur].len);
          int victim = victim_is_cur ? cur : prev;
          i64 amt = std::min(overlap, ms[victim].len);
          // genome-left crop for victim-cur, genome-right for victim-prev;
          // genome side maps to match side through the component's strand
          bool forward = seq == 0 ? true : !ms[victim].rev;
          bool match_left = (victim_is_cur == forward);
          crop_match(ms[victim], amt, match_left);
          changed = true;
        }
        i64 cur_r = left(cur) + ms[cur].len - 1;
        prev_r = left(prev) + ms[prev].len - 1;
        if (cur_r > prev_r || ms[prev].len <= 0) prev = cur;
      }
    }
    ms.erase(std::remove_if(ms.begin(), ms.end(),
                            [](const Match& m) { return m.len <= 0; }),
             ms.end());
    if (!changed) break;
  }
}

// Collinear greedy breakpoint elimination port (models/lcb.py
// greedy_breakpoint_elimination, min_weight < 0): partition matches into
// collinear runs by rank adjacency (computeLCBAdjacencies_v2 semantics) and
// drop the lightest block until one remains.
static void collinear_eliminate(std::vector<Match>& ms) {
  while (true) {
    std::vector<int> order(ms.size());
    for (size_t i = 0; i < ms.size(); i++) order[i] = (int)i;
    std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
      if (ms[x].a_left0 != ms[y].a_left0) return ms[x].a_left0 < ms[y].a_left0;
      return ms[x].b_left0 < ms[y].b_left0;
    });
    // rank of each match within the B ordering
    std::vector<int> border(order);
    std::stable_sort(border.begin(), border.end(), [&](int x, int y) {
      return ms[x].b_left0 < ms[y].b_left0;
    });
    std::vector<int> rank_b(ms.size());
    for (size_t i = 0; i < border.size(); i++) rank_b[border[i]] = (int)i;
    // block ids in A order: same strand and directly-adjacent B rank
    std::vector<int> block(ms.size());
    int nb = 0;
    for (size_t k = 0; k < order.size(); k++) {
      if (k > 0) {
        const Match& p = ms[order[k - 1]];
        const Match& c = ms[order[k]];
        int sign = c.rev ? -1 : 1;
        bool same = (p.rev == c.rev) &&
                    (rank_b[order[k]] - rank_b[order[k - 1]] == sign);
        if (!same) nb++;
      }
      block[order[k]] = nb;
    }
    if (nb == 0) break;  // single block
    std::vector<i64> weight(nb + 1, 0);
    for (size_t i = 0; i < ms.size(); i++) weight[block[i]] += ms[i].len;
    int victim = 0;
    for (int b = 1; b <= nb; b++)
      if (weight[b] < weight[victim]) victim = b;  // first minimum wins
    std::vector<Match> kept;
    for (size_t i = 0; i < ms.size(); i++)
      if (block[i] != victim) kept.push_back(ms[i]);
    ms = kept;
    if (ms.empty()) break;
  }
  std::sort(ms.begin(), ms.end(), [](const Match& x, const Match& y) {
    if (x.a_left0 != y.a_left0) return x.a_left0 < y.a_left0;
    return x.b_left0 < y.b_left0;
  });
  // make_collinear_nonoverlapping analog: crop the later match's left by
  // the max residual overlap over both sequences
  for (size_t k = 1; k < ms.size(); k++) {
    Match& p = ms[k - 1]; Match& c = ms[k];
    if (p.len <= 0) continue;
    i64 ov = std::max(p.a_left0 + p.len - c.a_left0,
                      p.b_left0 + p.len - c.b_left0);
    if (ov > 0) crop_match(c, std::min(ov, c.len), true);
  }
  ms.erase(std::remove_if(ms.begin(), ms.end(),
                          [](const Match& m) { return m.len <= 0; }),
           ms.end());
}

// Pairwise greedy breakpoint elimination (models/lcb.py
// greedy_breakpoint_elimination port, the reference's Aligner::align LCB
// loop, /root/reference/src/mauveAligner.cpp:668-698): partition matches
// into collinear blocks by rank adjacency, drop cohorts of minimum-weight
// blocks until every block's weight (sum of member lengths) reaches
// min_weight.  Emits the surviving blocks in seq-A order of their first
// anchor, each with members in chain order.
static void pairwise_lcb_eliminate(std::vector<Match>& ms, i64 min_weight,
                                   std::vector<std::vector<Match>>& out) {
  for (;;) {
    std::stable_sort(ms.begin(), ms.end(), [](const Match& x, const Match& y) {
      if (x.a_left0 != y.a_left0) return x.a_left0 < y.a_left0;
      return x.b_left0 < y.b_left0;
    });
    int n = (int)ms.size();
    if (n == 0) { out.clear(); return; }
    // seq-B ranks (stable over the seq-A order)
    std::vector<int> border(n);
    for (int i = 0; i < n; i++) border[i] = i;
    std::stable_sort(border.begin(), border.end(), [&](int x, int y) {
      return ms[x].b_left0 < ms[y].b_left0;
    });
    std::vector<int> rank_b(n);
    for (int i = 0; i < n; i++) rank_b[border[i]] = i;
    // block ids: same strand pattern + directly-adjacent B rank
    std::vector<int> block(n);
    int nb = 0;
    for (int i = 0; i < n; i++) {
      if (i > 0) {
        int expected = ms[i].rev ? -1 : 1;
        bool same = (ms[i].rev == ms[i - 1].rev) &&
                    (rank_b[i] - rank_b[i - 1] == expected);
        if (!same) nb++;
      }
      block[i] = nb;
    }
    std::vector<i64> weight(nb + 1, 0);
    for (int i = 0; i < n; i++) weight[block[i]] += ms[i].len;
    i64 wmin = *std::min_element(weight.begin(), weight.end());
    if (wmin >= min_weight) {
      out.assign(nb + 1, {});
      for (int i = 0; i < n; i++) out[block[i]].push_back(ms[i]);
      return;
    }
    i64 cutoff = std::min(min_weight, wmin * 2 + 1);
    std::vector<Match> kept;
    for (int i = 0; i < n; i++)
      if (weight[block[i]] >= cutoff) kept.push_back(ms[i]);
    ms = kept;
  }
}

// make_collinear_nonoverlapping port for one block's chain-ordered members
// (models/aligner.py): crop the later match's match-space left by the max
// residual overlap over both sequences; zero-length members drop.
static void make_chain_nonoverlapping(std::vector<Match>& ms) {
  int prev = -1;
  for (size_t k = 0; k < ms.size(); k++) {
    if (prev < 0) {
      if (ms[k].len > 0) prev = (int)k;
      continue;
    }
    Match& p = ms[prev];
    Match& c = ms[k];
    i64 ov = 0;
    // seq A gap (both forward in A)
    ov = std::max(ov, p.a_left0 + p.len - c.a_left0);
    // seq B: forward gap = c.left - (p.left + p.len); reverse gap =
    // p.left - (c.left + c.len) (chain walks right-to-left in genome B)
    if (!p.rev)
      ov = std::max(ov, p.b_left0 + p.len - c.b_left0);
    else
      ov = std::max(ov, c.b_left0 + c.len - p.b_left0);
    if (ov > 0) crop_match(c, std::min(ov, c.len), true);
    if (c.len > 0) prev = (int)k;
  }
  ms.erase(std::remove_if(ms.begin(), ms.end(),
                          [](const Match& m) { return m.len <= 0; }),
           ms.end());
}

// collinear chaining: weighted LIS over forward matches (the pairwise
// collinear case of greedy breakpoint elimination).
static void chain(std::vector<Match>& ms) {
  std::vector<Match> fwd;
  for (const Match& m : ms) if (!m.rev) fwd.push_back(m);
  std::sort(fwd.begin(), fwd.end(), [](const Match& x, const Match& y) {
    return x.a_left0 < y.a_left0;
  });
  // weighted LIS over (a, b) maximizing total anchor length (collinear
  // chaining; a greedy monotone walk was poisoned by the handful of random
  // cross matches light seeds produce — one early noise match with a large
  // B position blocked every real anchor after it)
  std::vector<Match> kept;
  {
    int n = (int)fwd.size();
    // Fenwick over b-rank holding (best chain length-sum, index)
    std::vector<i64> bs(n);
    for (int i = 0; i < n; i++) bs[i] = fwd[i].b_left0;
    std::sort(bs.begin(), bs.end());
    bs.erase(std::unique(bs.begin(), bs.end()), bs.end());
    int m = (int)bs.size();
    std::vector<std::pair<i64,int>> fen(m + 1, {0, -1});
    auto upd = [&](int r, i64 v, int idx) {
      for (r++; r <= m; r += r & -r)
        if (v > fen[r].first) fen[r] = {v, idx};
    };
    auto qry = [&](int r) {  // max over ranks < r
      std::pair<i64,int> best{0, -1};
      for (; r > 0; r -= r & -r)
        if (fen[r].first > best.first) best = fen[r];
      return best;
    };
    std::vector<i64> score(n);
    std::vector<int> prev(n, -1);
    for (int i = 0; i < n; i++) {  // fwd sorted by a_left0 (strictly inc)
      int r = (int)(std::lower_bound(bs.begin(), bs.end(), fwd[i].b_left0) -
                    bs.begin());
      auto best = qry(r);
      score[i] = best.first + fwd[i].len;
      prev[i] = best.second;
      upd(r, score[i], i);
    }
    int at = -1;
    i64 mx = 0;
    for (int i = 0; i < n; i++)
      if (score[i] > mx) { mx = score[i]; at = i; }
    std::vector<int> path;
    for (; at >= 0; at = prev[at]) path.push_back(at);
    for (auto it = path.rbegin(); it != path.rend(); ++it)
      kept.push_back(fwd[*it]);
  }
  // crop overlaps so inter-anchor gaps are non-negative
  for (size_t k = 1; k < kept.size(); k++) {
    Match& p = kept[k - 1]; Match& c = kept[k];
    i64 ov = std::max(p.a_left0 + p.len - c.a_left0,
                      p.b_left0 + p.len - c.b_left0);
    if (ov > 0) {
      i64 crop = std::min(ov, c.len);
      c.a_left0 += crop; c.b_left0 += crop; c.len -= crop;
    }
  }
  kept.erase(std::remove_if(kept.begin(), kept.end(),
                            [](const Match& m) { return m.len <= 0; }),
             kept.end());
  ms = kept;
}

// HOXD70 + affine gaps (the reference's hoxd scoring scheme)
static const int SUB[5][5] = {
    {91, -114, -31, -123, -44},  {-114, 100, -125, -31, -44},
    {-31, -125, 100, -114, -44}, {-123, -31, -114, 91, -44},
    {-44, -44, -44, -44, -44}};
static const int GAP_OPEN = -400, GAP_EXT = -30;
static const int NEG = -(1 << 28);

// Full Gotoh with affine-state traceback over one gap; returns aligned
// column count.  Decision byte layout matches the device kernel (ops/dp.py
// _gotoh_core): bits0-1 = H source (0 diag, 1 up/E-consume-A, 2 left/F),
// bit2 = E opened from H at this cell, bit3 = F opened from H.  Tie policy
// is the shared convention: diag > up > left; gap-open wins ties over
// gap-extend.  ops_out (optional) receives the start-to-end op string
// ('D' diag, 'U' consume A, 'L' consume B) for column-identity oracle runs.
static i64 gotoh(const uint8_t* a, i64 m, const uint8_t* b, i64 n,
                 std::vector<uint8_t>& tb, std::vector<int>& H,
                 std::vector<int>& E, std::vector<int>& F,
                 std::string* ops_out = nullptr) {
  if (m == 0 || n == 0) {
    if (ops_out) {
      ops_out->assign((size_t)m, 'U');
      ops_out->append((size_t)n, 'L');
    }
    return m + n;
  }
  tb.assign((size_t)(m + 1) * (n + 1), 0);
  H.assign(n + 1, 0); E.assign(n + 1, NEG); F.assign(n + 1, NEG);
  H[0] = 0;
  for (i64 j = 1; j <= n; j++) H[j] = GAP_OPEN + (int)j * GAP_EXT;
  for (i64 i = 1; i <= m; i++) {
    int diag = H[0];
    H[0] = GAP_OPEN + (int)i * GAP_EXT;
    int f_here = NEG;
    for (i64 j = 1; j <= n; j++) {
      bool e_open = H[j] + GAP_OPEN + GAP_EXT >= E[j] + GAP_EXT;
      E[j] = e_open ? H[j] + GAP_OPEN + GAP_EXT : E[j] + GAP_EXT;
      bool f_open = H[j - 1] + GAP_OPEN + GAP_EXT >= f_here + GAP_EXT;
      f_here = f_open ? H[j - 1] + GAP_OPEN + GAP_EXT : f_here + GAP_EXT;
      int hd = diag + SUB[a[i - 1] < 4 ? a[i - 1] : 4][b[j - 1] < 4 ? b[j - 1] : 4];
      int best = hd; uint8_t d = 0;
      if (E[j] > best) { best = E[j]; d = 1; }   // up: gap in B
      if (f_here > best) { best = f_here; d = 2; }  // left: gap in A
      diag = H[j];
      H[j] = best;
      tb[(size_t)i * (n + 1) + j] =
          d | (uint8_t)(e_open << 2) | (uint8_t)(f_open << 3);
    }
  }
  // affine-state traceback (follows gap runs through the open bits, so the
  // emitted path realizes the optimal score exactly like the device kernel)
  i64 i = m, j = n, cols = 0;
  int mode = 0;  // 0 = H, 1 = E (up run), 2 = F (left run)
  while (i > 0 || j > 0) {
    uint8_t byte = (i > 0 && j > 0) ? tb[(size_t)i * (n + 1) + j] : 0;
    int c = mode ? mode : (i == 0 ? 2 : (j == 0 ? 1 : (byte & 3)));
    if (c == 0) {
      i--; j--; mode = 0;
      if (ops_out) ops_out->push_back('D');
    } else if (c == 1) {
      mode = ((byte >> 2) & 1) ? 0 : 1;
      i--;
      if (ops_out) ops_out->push_back('U');
    } else {
      mode = ((byte >> 3) & 1) ? 0 : 2;
      j--;
      if (ops_out) ops_out->push_back('L');
    }
    cols++;
  }
  if (ops_out) std::reverse(ops_out->begin(), ops_out->end());
  return cols;
}

// child mode for --fork-closure: align two raw code files, print columns.
static int dp_child(const char* fa, const char* fb) {
  auto a = read_file(fa);
  auto b = read_file(fb);
  std::vector<uint8_t> tb; std::vector<int> H, E, F;
  i64 cols = gotoh(a.data(), a.size(), b.data(), b.size(), tb, H, E, F);
  printf("%lld\n", (long long)cols);
  return 0;
}

// fork/exec one DP child per gap, shipping the gap sequences through temp
// files — the reference's closure architecture (MuscleInterface writes the
// region to temp files and execs the bundled muscle_aed per inter-anchor
// region; process boundary documented in SURVEY.md §3.1/§3.2).
static i64 fork_closure_gap(const char* self, const uint8_t* a, i64 la,
                            const uint8_t* b, i64 lb) {
  char fa[64], fb[64];
  snprintf(fa, sizeof fa, "/tmp/refpipe_%d_a.raw", (int)getpid());
  snprintf(fb, sizeof fb, "/tmp/refpipe_%d_b.raw", (int)getpid());
  FILE* f = fopen(fa, "wb"); fwrite(a, 1, la, f); fclose(f);
  f = fopen(fb, "wb"); fwrite(b, 1, lb, f); fclose(f);
  pid_t pid = fork();
  if (pid == 0) {
    // silence the child's stdout like the reference redirects muscle's
    freopen("/dev/null", "w", stdout);
    execl(self, self, "--dp-child", fa, fb, (char*)nullptr);
    _exit(127);
  }
  int status = 0;
  waitpid(pid, &status, 0);
  return la + lb;  // column count is recomputed by the parent's bookkeeping
}

// ---------------------------------------------------------------------------
// --nway: progressive-class N-way measurement mode (the headline config's
// reference-architecture denominator).  Mirrors progressiveMauve's
// per-node profile alignment structure (/root/reference/src/
// progressiveMauve.cpp:575-710) at the algorithmic level, conservatively:
//   1. per-genome SMLs (LoadSMLs analog)
//   2. pairwise mer-sharing distances (MuscleInterface::CreateTree input)
//   3. UPGMA guide tree
//   4. per internal node: pairwise anchor search between the clade
//      representatives + collinear chaining + gapped closure of every
//      inter-anchor gap (in-process Gotoh, or one fork/exec'd DP child per
//      gap with --fork-closure — the reference's MUSCLE-subprocess closure
//      architecture)
// Conservative omissions (all of which ADD reference work): profile/
// consensus construction and per-node SML rebuilds (each node reuses one
// member's SML), recursive re-anchoring, iterative refinement, and the
// HomologyHMM backbone decode over every pairwise projection.
// ---------------------------------------------------------------------------
static int nway_main(int argc, char** argv) {
  bool fork_closure = false;
  std::vector<const char*> files;
  std::string pattern = argv[2];
  std::string rec_pattern;  // lighter seed for one gap-recursion round
  for (int k = 3; k < argc; k++) {
    if (strcmp(argv[k], "--fork-closure") == 0) fork_closure = true;
    else if (strcmp(argv[k], "--recursion-pattern") == 0 && k + 1 < argc)
      rec_pattern = argv[++k];
    else files.push_back(argv[k]);
  }
  int K = (int)files.size();
  if (K < 2) { fprintf(stderr, "--nway needs >= 2 genomes\n"); return 2; }
  std::vector<int> offs;
  for (size_t k = 0; k < pattern.size(); k++)
    if (pattern[k] == '1') offs.push_back((int)k);
  int L = (int)pattern.size();

  std::vector<std::vector<uint8_t>> G(K);
  for (int g = 0; g < K; g++) G[g] = read_file(files[g]);

  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::vector<Entry>> sml(K);
  for (int g = 0; g < K; g++) build_sml(G[g], offs, L, sml[g]);
  auto t1 = std::chrono::steady_clock::now();

  // pairwise distance = 1 - shared unique mers / min(unique counts)
  std::vector<std::vector<double>> dist(K, std::vector<double>(K, 0.0));
  for (int a = 0; a < K; a++) {
    for (int b = a + 1; b < K; b++) {
      const auto& sa = sml[a]; const auto& sb = sml[b];
      size_t i = 0, j = 0; i64 shared = 0, ua = 0, ub = 0;
      while (i < sa.size() && j < sb.size()) {
        u64 ma = sa[i].key >> 1, mb = sb[j].key >> 1;
        size_t i2 = i, j2 = j;
        if (ma <= mb) { while (i2 < sa.size() && (sa[i2].key >> 1) == ma) i2++; }
        if (mb <= ma) { while (j2 < sb.size() && (sb[j2].key >> 1) == mb) j2++; }
        if (ma == mb) {
          if (i2 - i == 1) ua++;
          if (j2 - j == 1) ub++;
          if (i2 - i == 1 && j2 - j == 1) shared++;
          i = i2; j = j2;
        } else if (ma < mb) { if (i2 - i == 1) ua++; i = i2; }
        else { if (j2 - j == 1) ub++; j = j2; }
      }
      i64 mn = ua < ub ? ua : ub;
      dist[a][b] = dist[b][a] = 1.0 - (mn > 0 ? (double)shared / mn : 0.0);
    }
  }
  auto t2 = std::chrono::steady_clock::now();

  // UPGMA join order; each cluster keeps a representative genome index
  struct Cl { std::vector<int> members; int rep; };
  std::vector<Cl> active;
  for (int g = 0; g < K; g++) active.push_back({{g}, g});
  std::vector<std::vector<double>> D = dist;
  std::vector<std::pair<int,int>> joins;  // representative pairs, in order
  std::vector<int> alive(K, 1);
  std::vector<int> idx(K);
  for (int g = 0; g < K; g++) idx[g] = g;
  int n_alive = K;
  while (n_alive > 1) {
    double best = 1e18; int ba = -1, bb = -1;
    for (int a = 0; a < K; a++) if (alive[a])
      for (int b = a + 1; b < K; b++) if (alive[b])
        if (D[a][b] < best) { best = D[a][b]; ba = a; bb = b; }
    joins.push_back({active[ba].rep, active[bb].rep});
    // UPGMA average-link update into slot ba
    int sa2 = (int)active[ba].members.size(), sb2 = (int)active[bb].members.size();
    for (int c = 0; c < K; c++) if (alive[c] && c != ba && c != bb)
      D[ba][c] = D[c][ba] =
          (D[ba][c] * sa2 + D[bb][c] * sb2) / (double)(sa2 + sb2);
    for (int m : active[bb].members) active[ba].members.push_back(m);
    // representative: the lower-index member (deterministic)
    if (active[bb].rep < active[ba].rep) active[ba].rep = active[bb].rep;
    alive[bb] = 0; n_alive--;
  }
  auto t3 = std::chrono::steady_clock::now();

  // per-node pairwise anchor + chain + closure between representatives,
  // with one gap-recursion round at a lighter seed (--recursion-pattern):
  // the reference re-anchors gaps >= 200 bp with lighter seeds before the
  // gapped closure (SetMinRecursionGapLength, src/mauveAligner.cpp:899) —
  // without it the heavy default seed finds almost nothing at >= 10%
  // divergence and the "baseline" would skip 90% of the alignment work.
  // rec_pattern is a comma-separated WEIGHT:PATTERN table; per gap the
  // weight is picked like the JAX recursion (min(log2(avg gap len),
  // heavy-2), floor 5 — models/aligner.py recursive_anchor)
  std::vector<std::pair<int, std::string>> rec_seeds;  // (weight, pattern)
  {
    size_t p0 = 0;
    while (p0 < rec_pattern.size()) {
      size_t comma = rec_pattern.find(',', p0);
      if (comma == std::string::npos) comma = rec_pattern.size();
      std::string tok = rec_pattern.substr(p0, comma - p0);
      size_t colon = tok.find(':');
      if (colon != std::string::npos)
        rec_seeds.push_back({atoi(tok.substr(0, colon).c_str()),
                             tok.substr(colon + 1)});
      p0 = comma + 1;
    }
  }
  int RL = rec_seeds.empty() ? 0 : 1;  // recursion enabled flag
  double match_s = 0, chain_s = 0, closure_s = 0, rec_s = 0;
  i64 cells = 0, aligned_cols = 0, n_gaps = 0, n_anchors = 0, n_rec = 0;
  std::vector<uint8_t> tb; std::vector<int> H, E, F;
  std::function<void(const uint8_t*, i64, const uint8_t*, i64, int)>
      recurse_gap;
  auto close_gap = [&](const uint8_t* a, i64 la, const uint8_t* b, i64 lb) {
    if (la > 4096) la = 4096;
    if (lb > 4096) lb = 4096;
    if (la == 0 && lb == 0) return;
    n_gaps++; cells += la * lb;
    if (fork_closure)
      aligned_cols += fork_closure_gap(argv[0], a, la, b, lb);
    else
      aligned_cols += gotoh(a, la, b, lb, tb, H, E, F);
  };
  recurse_gap = [&](const uint8_t* a, i64 la, const uint8_t* b, i64 lb,
                    int depth) {
    // per-gap weight like the JAX recursion: log2(avg len) clamped to
    // [5, heavy-2]; pick the nearest table entry at or below it
    double avg = 0.5 * (double)(la + lb);
    int w = (int)(0.5 + log2(avg > 2 ? avg : 2.0));
    int wmax = (int)offs.size() - 2;
    if (w > wmax) w = wmax;
    if (w < 5) w = 5;
    const std::string* pat = nullptr;
    int best = -1;
    for (auto& [tw, tp] : rec_seeds)
      if (tw <= w && tw > best) { best = tw; pat = &tp; }
    if (!pat || depth >= 3 || la < 200 || lb < 200) {
      close_gap(a, la, b, lb);
      return;
    }
    auto r0 = std::chrono::steady_clock::now();
    std::vector<int> ro;
    for (size_t k = 0; k < pat->size(); k++)
      if ((*pat)[k] == '1') ro.push_back((int)k);
    std::vector<uint8_t> gav(a, a + la), gbv(b, b + lb);
    std::vector<Entry> rsa, rsb;
    build_sml(gav, ro, (int)pat->size(), rsa);
    build_sml(gbv, ro, (int)pat->size(), rsb);
    std::vector<Match> sub;
    find_mums(gav, gbv, rsa, rsb, (int)pat->size(), sub);
    chain(sub);
    rec_s += secs(r0, std::chrono::steady_clock::now());
    n_rec += (i64)sub.size();
    if (sub.empty()) {
      close_gap(a, la, b, lb);
      return;
    }
    i64 pa = 0, pb = 0;
    for (const Match& m : sub) {
      recurse_gap(gav.data() + pa, m.a_left0 - pa, gbv.data() + pb,
                  m.b_left0 - pb, depth + 1);
      aligned_cols += m.len;
      pa = m.a_left0 + m.len; pb = m.b_left0 + m.len;
    }
    recurse_gap(gav.data() + pa, la - pa, gbv.data() + pb, lb - pb, depth + 1);
  };
  for (auto [ra, rb] : joins) {
    auto m0 = std::chrono::steady_clock::now();
    std::vector<Match> ms;
    find_mums(G[ra], G[rb], sml[ra], sml[rb], L, ms);
    auto m1 = std::chrono::steady_clock::now();
    chain(ms);
    auto m2 = std::chrono::steady_clock::now();
    n_anchors += (i64)ms.size();
    // synthetic chain endpoints so head/tail gaps close too
    std::vector<Match> walk;
    walk.push_back({0, 0, 0, false});
    for (const Match& m : ms) walk.push_back(m);
    walk.push_back({(i64)G[ra].size(), (i64)G[rb].size(), 0, false});
    for (size_t k = 1; k < walk.size(); k++) {
      i64 ga0 = walk[k - 1].a_left0 + walk[k - 1].len;
      i64 gb0 = walk[k - 1].b_left0 + walk[k - 1].len;
      i64 la = walk[k].a_left0 - ga0, lb = walk[k].b_left0 - gb0;
      if (la < 0 || lb < 0) continue;
      if (RL > 0 && la >= 200 && lb >= 200)
        recurse_gap(G[ra].data() + ga0, la, G[rb].data() + gb0, lb, 0);
      else
        close_gap(G[ra].data() + ga0, la, G[rb].data() + gb0, lb);
    }
    for (const Match& m : ms) aligned_cols += m.len;
    auto m3 = std::chrono::steady_clock::now();
    match_s += secs(m0, m1); chain_s += secs(m1, m2);
    closure_s += secs(m2, m3);
  }
  closure_s -= rec_s;
  auto t4 = std::chrono::steady_clock::now();
  printf("{\"sml_s\": %.3f, \"dist_s\": %.3f, \"tree_s\": %.3f, "
         "\"match_s\": %.3f, \"chain_s\": %.3f, \"recursion_s\": %.3f, "
         "\"closure_s\": %.3f, "
         "\"total_s\": %.3f, \"n_genomes\": %d, \"n_merges\": %zu, "
         "\"n_anchors\": %lld, \"n_rec_anchors\": %lld, \"n_gaps\": %lld, "
         "\"dp_cells\": %lld, \"aligned_cols\": %lld}\n",
         secs(t0, t1), secs(t1, t2), secs(t2, t3), match_s, chain_s, rec_s,
         closure_s, secs(t0, t4), K, joins.size(), (long long)n_anchors,
         (long long)n_rec, (long long)n_gaps, (long long)cells,
         (long long)aligned_cols);
  return 0;
}

int main(int argc, char** argv) {
  if (argc >= 4 && strcmp(argv[1], "--dp-child") == 0)
    return dp_child(argv[2], argv[3]);
  if (argc >= 5 && strcmp(argv[1], "--nway") == 0)
    return nway_main(argc, argv);
  if (argc < 4) {
    fprintf(stderr,
            "usage: %s <pattern> <codesA.raw> <codesB.raw> "
            "[--fork-closure] [--emit-aln <path>]\n",
            argv[0]);
    return 2;
  }
  bool fork_closure = argc > 4 && strcmp(argv[4], "--fork-closure") == 0;
  // column-identity oracle mode: write the chained alignment's exact column
  // structure (anchor rows + per-gap op strings) for the golden diff
  // against the JAX pipeline's XMFA (writer semantics it must match:
  // /root/reference/src/mauveAligner.cpp:702,750)
  const char* emit_path = nullptr;
  const char* emit_lcbs = nullptr;
  for (int k = 4; k + 1 < argc; k++) {
    if (strcmp(argv[k], "--emit-aln") == 0) emit_path = argv[k + 1];
    if (strcmp(argv[k], "--emit-lcbs") == 0) emit_lcbs = argv[k + 1];
  }
  std::string pattern = argv[1];
  std::vector<int> offs;
  for (size_t k = 0; k < pattern.size(); k++)
    if (pattern[k] == '1') offs.push_back((int)k);
  int L = (int)pattern.size();
  auto A = read_file(argv[2]);
  auto B = read_file(argv[3]);

  auto t0 = std::chrono::steady_clock::now();
  std::vector<Entry> sa, sb;
  build_sml(A, offs, L, sa);
  build_sml(B, offs, L, sb);
  auto t1 = std::chrono::steady_clock::now();

  std::vector<Match> ms;
  find_mums(A, B, sa, sb, L, ms,
            /*extend_all=*/emit_path != nullptr || emit_lcbs != nullptr);
  auto t2 = std::chrono::steady_clock::now();

  if (emit_lcbs) {
    // LCB-mode column oracle: overlap elimination + greedy breakpoint
    // elimination keeping MULTIPLE blocks (the JAX MauveAligner's
    // determine_lcbs semantics with the default weight threshold
    // seed_weight*3*n_seqs, /root/reference/src/mauveAligner.cpp:648-656),
    // then per-LCB chain cropping + gap DP, reverse strand included.
    canonical_sort(ms);
    eliminate_overlaps_v2(ms);
    std::vector<std::vector<Match>> lcbs;
    pairwise_lcb_eliminate(ms, (i64)offs.size() * 3 * 2, lcbs);
    std::sort(lcbs.begin(), lcbs.end(),
              [](const std::vector<Match>& x, const std::vector<Match>& y) {
                if (x.empty() || y.empty()) return x.size() > y.size();
                return x[0].a_left0 < y[0].a_left0;
              });
    FILE* f = fopen(emit_lcbs, "w");
    std::vector<uint8_t> tb2; std::vector<int> H2, E2, F2;
    std::string ops2;
    for (size_t li = 0; li < lcbs.size(); li++) {
      auto& blk = lcbs[li];
      make_chain_nonoverlapping(blk);
      if (blk.empty()) continue;
      fprintf(f, "L %zu %d\n", li, blk[0].rev ? 1 : 0);
      fprintf(f, "A %lld %lld %lld\n", (long long)blk[0].a_left0,
              (long long)blk[0].b_left0, (long long)blk[0].len);
      for (size_t k = 1; k < blk.size(); k++) {
        const Match& p = blk[k - 1];
        const Match& c = blk[k];
        i64 ga0 = p.a_left0 + p.len;
        i64 la = c.a_left0 - ga0;
        i64 gb0, lb;
        if (!c.rev) { gb0 = p.b_left0 + p.len; lb = c.b_left0 - gb0; }
        else { gb0 = c.b_left0 + c.len; lb = p.b_left0 - gb0; }
        if (la < 0 || lb < 0) { la = la < 0 ? 0 : la; lb = lb < 0 ? 0 : lb; }
        if (la == 0 && lb == 0) {
          fprintf(f, "A %lld %lld %lld\n", (long long)c.a_left0,
                  (long long)c.b_left0, (long long)c.len);
          continue;
        }
        if (la > 4096 || lb > 4096) {
          fprintf(f, "S %lld %lld\n", (long long)la, (long long)lb);
        } else {
          // match-space B codes: forward slice, or revcomp for rev blocks
          std::vector<uint8_t> breg((size_t)lb);
          for (i64 i2 = 0; i2 < lb; i2++) {
            uint8_t cb = B[c.rev ? gb0 + lb - 1 - i2 : gb0 + i2];
            breg[i2] = (c.rev && cb < 4) ? (uint8_t)(3 - cb) : cb;
          }
          ops2.clear();
          gotoh(A.data() + ga0, la, breg.data(), lb, tb2, H2, E2, F2, &ops2);
          fprintf(f, "G %s\n", ops2.c_str());
        }
        fprintf(f, "A %lld %lld %lld\n", (long long)c.a_left0,
                (long long)c.b_left0, (long long)c.len);
      }
    }
    fclose(f);
    printf("{\"mode\": \"emit-lcbs\", \"n_lcbs\": %zu, \"n_matches\": %zu}\n",
           lcbs.size(), ms.size());
    return 0;
  }

  if (emit_path) {  // oracle mode: the pipeline's exact chaining semantics
    canonical_sort(ms);
    eliminate_overlaps_v2(ms);
    collinear_eliminate(ms);
  } else {
    chain(ms);
  }
  auto t3 = std::chrono::steady_clock::now();

  // gapped closure of every inter-anchor gap (cap 4096 per side, the
  // --max-gapped-aligner-length default, src/mauveAligner.cpp:675-676)
  std::vector<uint8_t> tb; std::vector<int> H, E, F;
  FILE* emit = emit_path ? fopen(emit_path, "w") : nullptr;
  if (emit && !ms.empty())
    fprintf(emit, "A %lld %lld %lld\n", (long long)ms[0].a_left0,
            (long long)ms[0].b_left0, (long long)ms[0].len);
  i64 cells = 0, aligned_cols = 0, n_gaps = 0;
  std::string ops;
  for (size_t k = 1; k < ms.size(); k++) {
    i64 ga0 = ms[k - 1].a_left0 + ms[k - 1].len;
    i64 ga1 = ms[k].a_left0;
    i64 gb0 = ms[k - 1].b_left0 + ms[k - 1].len;
    i64 gb1 = ms[k].b_left0;
    i64 la = ga1 - ga0, lb = gb1 - gb0;
    if (la < 0 || lb < 0) continue;
    i64 full_la = la, full_lb = lb;
    if (!emit) {  // measurement mode caps like the reference
      if (la > 4096) la = 4096;
      if (lb > 4096) lb = 4096;
    }
    if (la == 0 && lb == 0) {
      if (emit)
        fprintf(emit, "A %lld %lld %lld\n", (long long)ms[k].a_left0,
                (long long)ms[k].b_left0, (long long)ms[k].len);
      continue;
    }
    n_gaps++;
    if (emit && (full_la > 4096 || full_lb > 4096)) {
      // over the --max-gapped-aligner-length cap: both pipelines emit the
      // regions unaligned (A block then B block)
      fprintf(emit, "S %lld %lld\n", (long long)full_la, (long long)full_lb);
      fprintf(emit, "A %lld %lld %lld\n", (long long)ms[k].a_left0,
              (long long)ms[k].b_left0, (long long)ms[k].len);
      continue;
    }
    cells += la * lb;
    if (fork_closure)  // the CHILD performs the DP, as the reference does
      aligned_cols += fork_closure_gap(argv[0], A.data() + ga0, la,
                                       B.data() + gb0, lb);
    else {
      ops.clear();
      aligned_cols += gotoh(A.data() + ga0, la, B.data() + gb0, lb, tb, H, E,
                            F, emit ? &ops : nullptr);
      if (emit) {
        fprintf(emit, "G %s\n", ops.c_str());
        fprintf(emit, "A %lld %lld %lld\n", (long long)ms[k].a_left0,
                (long long)ms[k].b_left0, (long long)ms[k].len);
      }
    }
  }
  if (emit) fclose(emit);
  for (const Match& m : ms) aligned_cols += m.len;
  auto t4 = std::chrono::steady_clock::now();

  printf("{\"sml_s\": %.3f, \"match_s\": %.3f, \"chain_s\": %.3f, "
         "\"closure_s\": %.3f, \"total_s\": %.3f, \"n_anchors\": %zu, "
         "\"n_gaps\": %lld, \"dp_cells\": %lld, \"aligned_cols\": %lld}\n",
         secs(t0, t1), secs(t1, t2), secs(t2, t3), secs(t3, t4), secs(t0, t4),
         ms.size(), (long long)n_gaps, (long long)cells,
         (long long)aligned_cols);
  return 0;
}
