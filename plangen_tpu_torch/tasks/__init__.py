"""Host-side batch construction and the layout-to-image pipeline."""
