"""Host-side analysis tools of the port: the paged pool's sanitizer."""
