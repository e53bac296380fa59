// K2g's cluster mode (fftg_cluster_impl.cuh) on float64 cubes: one of the
// three sources it is built in, so that the library's parallel build is
// not held by one long compile.
#include "fftg_cluster_impl.cuh"

ICLN_FFTG_CLUSTER_BUILD(double)
