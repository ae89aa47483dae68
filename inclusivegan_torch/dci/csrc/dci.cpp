// Prioritized DCI implementation — see dci.hpp for provenance and design.
#include "dci.hpp"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace dci {

Index::Index(int dim, int num_comp, int num_simp, uint64_t seed)
    : dim_(dim), num_comp_(num_comp), num_simp_(num_simp), seed_(seed) {
  reset(seed);
}

void Index::reset(uint64_t seed) {
  clear();
  seed_ = seed;
  const int T = num_comp_ * num_simp_;
  proj_vecs_.assign(static_cast<size_t>(T) * dim_, 0.0);
  std::mt19937_64 rng(seed);
  std::normal_distribution<double> normal(0.0, 1.0);
  for (int t = 0; t < T; ++t) {
    double* v = &proj_vecs_[static_cast<size_t>(t) * dim_];
    double norm2 = 0.0;
    for (int d = 0; d < dim_; ++d) {
      v[d] = normal(rng);
      norm2 += v[d] * v[d];
    }
    const double inv = 1.0 / std::sqrt(norm2 + 1e-300);
    for (int d = 0; d < dim_; ++d) v[d] *= inv;
  }
}

void Index::clear() {
  n_ = 0;
  data_ = nullptr;
  ext_proj_ = nullptr;
  own_proj_.clear();
  own_proj_.shrink_to_fit();
  levels_.clear();
}

double Index::exact_dist2(const double* a, const double* b) const {
  double acc = 0.0;
  for (int d = 0; d < dim_; ++d) {
    const double diff = a[d] - b[d];
    acc += diff * diff;
  }
  return acc;
}

void Index::build_cell(Cell* cell, const std::vector<int>& members) const {
  const int T = num_comp_ * num_simp_;
  const double* proj = ext_proj_ ? ext_proj_ : own_proj_.data();
  cell->members = members;
  cell->tables.assign(T, {});
  for (int t = 0; t < T; ++t) {
    auto& table = cell->tables[t];
    table.reserve(members.size());
    for (int id : members) {
      table.push_back({proj[static_cast<size_t>(id) * T + t], id});
    }
    std::sort(table.begin(), table.end());
  }
}

// Descend levels [0, upto_level], returning the candidate ids retrieved at
// level `upto_level`. Shared by query() and the construction-time
// nearest-promoted-point assignment.
std::vector<int> Index::descend(const double* qi, const double* qp,
                                int upto_level, const QueryOptions& opt,
                                int exclude_id) const {
  std::vector<int> active_cells = {0};
  std::vector<int> cand;
  for (int lev = 0; lev <= upto_level; ++lev) {
    cand.clear();
    for (int c : active_cells) {
      search_cell(levels_[lev].cells[c], qp, opt, &cand);
    }
    if (lev == upto_level) break;
    // rank promoted candidates by exact distance, descend into their cells
    std::vector<std::pair<double, int>> ranked;
    ranked.reserve(cand.size());
    for (int id : cand) {
      if (id == exclude_id) continue;
      ranked.push_back(
          {exact_dist2(qi, data_ + static_cast<size_t>(id) * dim_), id});
    }
    const size_t keep = std::min<size_t>(
        ranked.size(), static_cast<size_t>(opt.field_of_view));
    std::partial_sort(ranked.begin(), ranked.begin() + keep, ranked.end());
    active_cells.clear();
    for (size_t r = 0; r < keep; ++r) {
      const int cid = levels_[lev].child_cell[ranked[r].second];
      if (cid >= 0) active_cells.push_back(cid);
    }
    if (active_cells.empty()) active_cells.push_back(0);
  }
  return cand;
}

void Index::add(long n, const double* data, const double* projections,
                int num_levels) {
  levels_.clear();
  n_ = n;
  data_ = data;
  num_levels_ = std::max(num_levels, 1);
  const int T = num_comp_ * num_simp_;

  if (projections != nullptr) {
    ext_proj_ = projections;
    own_proj_.clear();
  } else {
    // Self-contained path: project here (gcc vectorizes the inner loop).
    ext_proj_ = nullptr;
    own_proj_.assign(static_cast<size_t>(n) * T, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; ++i) {
      const double* x = data + static_cast<size_t>(i) * dim_;
      double* out = &own_proj_[static_cast<size_t>(i) * T];
      for (int t = 0; t < T; ++t) {
        const double* v = &proj_vecs_[static_cast<size_t>(t) * dim_];
        double acc = 0.0;
        for (int d = 0; d < dim_; ++d) acc += x[d] * v[d];
        out[t] = acc;
      }
    }
  }

  // Promoted subsets are prefixes of one pseudo-random permutation: level l
  // holds the first ~n^((l+1)/L) entries; the finest level holds all points.
  std::vector<int> perm(n);
  for (long i = 0; i < n; ++i) perm[i] = static_cast<int>(i);
  std::mt19937_64 rng(seed_ ^ 0x9E3779B97F4A7C15ull);
  std::shuffle(perm.begin(), perm.end(), rng);

  std::vector<long> level_sizes(num_levels_);
  for (int l = 0; l < num_levels_; ++l) {
    const double frac = static_cast<double>(l + 1) / num_levels_;
    level_sizes[l] = std::max<long>(
        1, static_cast<long>(
               std::ceil(std::pow(static_cast<double>(n), frac))));
  }
  level_sizes[num_levels_ - 1] = n;

  levels_.resize(num_levels_);
  {
    std::vector<int> members(perm.begin(), perm.begin() + level_sizes[0]);
    levels_[0].cells.resize(1);
    build_cell(&levels_[0].cells[0], members);
  }

  QueryOptions assign_opt;
  assign_opt.num_neighbours = 1;
  assign_opt.max_retrieve = 32;
  assign_opt.max_visits = 512;
  assign_opt.field_of_view = 4;

  for (int l = 0; l + 1 < num_levels_; ++l) {
    const long parent_count = level_sizes[l];
    Level& parent = levels_[l];
    parent.child_cell.assign(n, -1);
    for (long c = 0; c < parent_count; ++c)
      parent.child_cell[perm[c]] = static_cast<int>(c);

    const long child_count = level_sizes[l + 1];
    std::vector<int> assignment(child_count, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (long i = 0; i < child_count; ++i) {
      const int pid = perm[i];
      const double* proj = ext_proj_ ? ext_proj_ : own_proj_.data();
      const double* qp = proj + static_cast<size_t>(pid) * T;
      const double* qi = data_ + static_cast<size_t>(pid) * dim_;
      std::vector<int> cand = descend(qi, qp, l, assign_opt, pid);
      int best = perm[0];
      double best_d = 1e300;
      for (int id : cand) {
        if (id == pid) continue;
        const double d2 =
            exact_dist2(qi, data_ + static_cast<size_t>(id) * dim_);
        if (d2 < best_d) {
          best_d = d2;
          best = id;
        }
      }
      assignment[i] = parent.child_cell[best] >= 0 ? parent.child_cell[best] : 0;
    }

    Level& child = levels_[l + 1];
    child.cells.resize(parent_count);
    std::vector<std::vector<int>> buckets(parent_count);
    for (long i = 0; i < child_count; ++i)
      buckets[assignment[i]].push_back(perm[i]);
    for (long c = 0; c < parent_count; ++c) {
      bool has_owner = false;
      for (int id : buckets[c])
        if (id == perm[c]) { has_owner = true; break; }
      if (!has_owner) buckets[c].push_back(perm[c]);
      build_cell(&child.cells[c], buckets[c]);
    }
  }
}

namespace {
struct PQItem {
  double key;  // |table value - query projection|
  int table;   // which of the T tables
  long pos;    // current position in the table
  int dir;     // -1 walking left, +1 walking right
  bool operator>(const PQItem& o) const { return key > o.key; }
};
}  // namespace

void Index::search_cell(const Cell& cell, const double* qproj,
                        const QueryOptions& opt, std::vector<int>* out) const {
  const int T = num_comp_ * num_simp_;
  const long m = static_cast<long>(cell.members.size());
  if (m == 0) return;
  if (m <= opt.max_retrieve) {  // small cell: take everything
    out->insert(out->end(), cell.members.begin(), cell.members.end());
    return;
  }

  std::unordered_map<long, int> counter;
  counter.reserve(static_cast<size_t>(opt.max_visits) * 2);

  std::priority_queue<PQItem, std::vector<PQItem>, std::greater<PQItem>> pq;
  for (int t = 0; t < T; ++t) {
    const auto& table = cell.tables[t];
    const double qv = qproj[t];
    auto it = std::lower_bound(table.begin(), table.end(), Entry{qv, -1});
    long right = it - table.begin();
    long left = right - 1;
    if (right < static_cast<long>(table.size()))
      pq.push({std::abs(table[right].key - qv), t, right, +1});
    if (left >= 0)
      pq.push({std::abs(table[left].key - qv), t, left, -1});
  }

  long retrieved = 0;
  long visits = 0;
  const long visit_budget = opt.max_visits * num_comp_;
  while (!pq.empty() && retrieved < opt.max_retrieve &&
         visits < visit_budget) {
    PQItem item = pq.top();
    pq.pop();
    ++visits;
    const auto& table = cell.tables[item.table];
    const int id = table[item.pos].id;
    const int comp = item.table / num_simp_;
    int& cnt = counter[static_cast<long>(id) * num_comp_ + comp];
    ++cnt;
    if (cnt == num_simp_) {
      out->push_back(id);
      ++retrieved;
    }
    const long next = item.pos + item.dir;
    if (next >= 0 && next < static_cast<long>(table.size())) {
      pq.push({std::abs(table[next].key - qproj[item.table]), item.table,
               next, item.dir});
    }
  }
}

void Index::query(long nq, const double* q, const double* qproj,
                  const QueryOptions& opt, int* out_ids, double* out_dists,
                  int* out_counts) const {
  const int T = num_comp_ * num_simp_;
  const int k = opt.num_neighbours;

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<double> qp_local(T);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (long i = 0; i < nq; ++i) {
      const double* qi = q + static_cast<size_t>(i) * dim_;
      const double* qp;
      if (qproj != nullptr) {
        qp = qproj + static_cast<size_t>(i) * T;
      } else {
        for (int t = 0; t < T; ++t) {
          const double* v = &proj_vecs_[static_cast<size_t>(t) * dim_];
          double acc = 0.0;
          for (int d = 0; d < dim_; ++d) acc += qi[d] * v[d];
          qp_local[t] = acc;
        }
        qp = qp_local.data();
      }

      std::vector<int> cand = descend(qi, qp, num_levels_ - 1, opt, -1);
      // a point can surface through more than one composite index — dedupe
      std::sort(cand.begin(), cand.end());
      cand.erase(std::unique(cand.begin(), cand.end()), cand.end());

      std::vector<std::pair<double, int>> ranked;
      ranked.reserve(cand.size());
      for (int id : cand) {
        ranked.push_back(
            {exact_dist2(qi, data_ + static_cast<size_t>(id) * dim_), id});
      }
      const int found = static_cast<int>(
          std::min<size_t>(ranked.size(), static_cast<size_t>(k)));
      std::partial_sort(ranked.begin(), ranked.begin() + found, ranked.end());
      out_counts[i] = found;
      for (int j = 0; j < found; ++j) {
        out_ids[i * k + j] = ranked[j].second;
        out_dists[i * k + j] = std::sqrt(ranked[j].first);
      }
      for (int j = found; j < k; ++j) {
        out_ids[i * k + j] = -1;
        out_dists[i * k + j] = -1.0;
      }
    }
  }
}

}  // namespace dci
