"""Host-side acquisition helpers of the port (numpy)."""
