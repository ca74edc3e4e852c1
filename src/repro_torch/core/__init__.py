"""Routing core of the port: the Eq. 28 centroid router, the balanced
spherical k-means that partitions the training data, and the Eq. 27
mixture of the experts' next-token distributions."""
