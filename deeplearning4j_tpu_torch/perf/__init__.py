"""Host-side performance helpers of the port."""
