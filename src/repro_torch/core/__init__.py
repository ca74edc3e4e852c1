"""Routing core of the port: the Eq. 28 centroid router and the balanced
spherical k-means that partitions the training data."""
