// The float64 entry of the collision kernel (K3, K4): collisions.cu, compiled
// apart from its float32 entry so that the two builds run in parallel.
#define QP_COLLISIONS_F64
#include "collisions.cu"
