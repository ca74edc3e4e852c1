"""Serving stack of the port: API objects, the fused epilogue and the
paged, chunked slot servers behind the centroid router."""
