"""Plain f32 references of the configurations: torch operations only, nothing of the port."""
