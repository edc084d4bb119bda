"""Host utilities: pixels to PNG and back."""
