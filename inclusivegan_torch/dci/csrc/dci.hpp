// Prioritized DCI (Dynamic Continuous Indexing) — fresh C++ implementation
// of the k-NN capability the reference gets from its C library
// (dci_code/src/dci.c, include/dci.h). Written from the
// algorithm in Li & Malik, "Fast k-Nearest Neighbour Search via Prioritized
// DCI" (ICML 2017); no code derived from the reference.
//
// Division of labor in the PyTorch port (see ../__init__.py):
//   * projections (data @ random unit directions) are a dense matmul →
//     computed as one torch.matmul on the card and passed in;
//   * this library owns what is no matrix product: per-direction sorted
//     tables, the priority-queue guided traversal, and the multi-level
//     cell tree. A self-contained CPU path (internal projections +
//     distances) is kept for standalone use and tests.
#pragma once

#include <cstdint>
#include <vector>

namespace dci {

struct QueryOptions {
  int num_neighbours = 1;
  // candidates to retrieve (exact-ranked) per query at the finest level:
  long max_retrieve = 200;
  // priority-queue pops per composite index before giving up:
  long max_visits = 4000;
  // non-leaf levels: number of nearest cells to descend into:
  int field_of_view = 10;
};

class Index {
 public:
  Index(int dim, int num_comp, int num_simp, uint64_t seed);

  // Borrow `data` ([n, dim], row-major float64; caller keeps it alive).
  // If `projections` is non-null it must be [n, num_comp*num_simp] and is
  // borrowed too; otherwise projections are computed here.
  // num_levels >= 1 builds a cell tree with ~n^((L-l)/L) points per level.
  void add(long n, const double* data, const double* projections,
           int num_levels);

  // Query `nq` points ([nq, dim]); qproj optional precomputed
  // [nq, num_comp*num_simp]. Writes k ids + exact distances per query.
  // Returns the number of neighbours actually found per query in out_counts.
  void query(long nq, const double* q, const double* qproj,
             const QueryOptions& opt, int* out_ids, double* out_dists,
             int* out_counts) const;

  void clear();           // drop points, keep projection directions
  void reset(uint64_t seed);  // drop points AND re-draw directions

  long num_points() const { return n_; }
  int num_levels() const { return num_levels_; }
  int dim() const { return dim_; }
  int num_indices() const { return num_comp_ * num_simp_; }
  const double* proj_vecs() const { return proj_vecs_.data(); }

 private:
  struct Entry {
    double key;  // projection value
    int id;      // point id (global)
    bool operator<(const Entry& o) const { return key < o.key; }
  };
  // One level of the tree: a set of cells, each with its own sorted tables.
  struct Cell {
    // tables[t] = entries of this cell sorted by projection t.
    std::vector<std::vector<Entry>> tables;
    std::vector<int> members;  // global point ids in this cell
  };
  struct Level {
    std::vector<Cell> cells;
    // cell_of[global_point_id] → cell index at the NEXT (finer) level that
    // this point owns (only for promoted points).
    std::vector<int> child_cell;
  };

  void build_cell(Cell* cell, const std::vector<int>& members) const;
  // Walk levels [0, upto_level]; returns candidate ids found at upto_level.
  std::vector<int> descend(const double* qi, const double* qp,
                           int upto_level, const QueryOptions& opt,
                           int exclude_id) const;
  // Prioritized traversal of one cell; appends up to max_retrieve candidate
  // ids (exact-ranked by caller). visited is an epoch-stamped scratch.
  void search_cell(const Cell& cell, const double* qproj,
                   const QueryOptions& opt, std::vector<int>* out) const;

  double exact_dist2(const double* a, const double* b) const;

  int dim_, num_comp_, num_simp_;
  long n_ = 0;
  int num_levels_ = 1;
  const double* data_ = nullptr;
  const double* ext_proj_ = nullptr;  // borrowed [n, T] if provided
  std::vector<double> own_proj_;      // computed here otherwise
  std::vector<double> proj_vecs_;     // [T, dim] random unit directions
  std::vector<Level> levels_;         // levels_[0] = coarsest
  uint64_t seed_;
};

}  // namespace dci
