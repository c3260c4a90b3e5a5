"""Host-side utilities of the port: CSV logging in the reference's file formats."""
