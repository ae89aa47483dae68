// C ABI for ctypes binding (the reference used a CPython extension,
// dci_code/src/py_dci.c; ctypes avoids a compile-time
// dependency on Python headers).
#include "dci.hpp"

extern "C" {

void* dci_new(int dim, int num_comp, int num_simp, unsigned long long seed) {
  return new dci::Index(dim, num_comp, num_simp, seed);
}

void dci_free(void* h) { delete static_cast<dci::Index*>(h); }

void dci_add(void* h, long n, const double* data, const double* projections,
             int num_levels) {
  static_cast<dci::Index*>(h)->add(n, data, projections, num_levels);
}

void dci_query(void* h, long nq, const double* q, const double* qproj,
               int num_neighbours, long max_retrieve, long max_visits,
               int field_of_view, int* out_ids, double* out_dists,
               int* out_counts) {
  dci::QueryOptions opt;
  opt.num_neighbours = num_neighbours;
  opt.max_retrieve = max_retrieve;
  opt.max_visits = max_visits;
  opt.field_of_view = field_of_view;
  static_cast<dci::Index*>(h)->query(nq, q, qproj, opt, out_ids, out_dists,
                                     out_counts);
}

void dci_clear(void* h) { static_cast<dci::Index*>(h)->clear(); }

void dci_reset(void* h, unsigned long long seed) {
  static_cast<dci::Index*>(h)->reset(seed);
}

long dci_num_points(void* h) {
  return static_cast<dci::Index*>(h)->num_points();
}

int dci_num_levels(void* h) {
  return static_cast<dci::Index*>(h)->num_levels();
}

void dci_get_proj_vecs(void* h, double* out) {
  const dci::Index* idx = static_cast<dci::Index*>(h);
  const long total =
      static_cast<long>(idx->num_indices()) * idx->dim();
  const double* src = idx->proj_vecs();
  for (long i = 0; i < total; ++i) out[i] = src[i];
}

}  // extern "C"
