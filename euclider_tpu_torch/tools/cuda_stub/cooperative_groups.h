// Host stand-in for the cooperative groups that csrc/ uses (a thread-block
// cluster's barrier, size, rank and shared-memory mapping), so that g++
// compiles the device code around them (tools/kernel_harness.py): one
// block stands in for the cluster.  The harness takes a tile's sums and
// decisions over the lanes itself: P1's in the cluster's order
// (ops/march_probe.py tile_sum), P2's, P4's, P5's and P6's in the lanes'
// order.
#pragma once
namespace cooperative_groups {
struct cluster_group {
    void sync() const {}
    unsigned num_blocks() const { return 1; }
    unsigned block_rank() const { return 0; }
    template <class T>
    T* map_shared_rank(T* addr, int) const { return addr; }
};
inline cluster_group this_cluster() { return cluster_group{}; }
}  // namespace cooperative_groups
