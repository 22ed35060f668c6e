"""Host-side supervision utilities shared by the port's services."""
