"""Model configurations, registered by architecture id."""
