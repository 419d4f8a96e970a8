"""GPU kernels (Pallas), BVH traversal and native host helpers."""
