"""Performance helpers of the port: shape buckets, device evaluation, the
epoch cache with its chunk driver, and CUDA-graph capture of training
steps."""
