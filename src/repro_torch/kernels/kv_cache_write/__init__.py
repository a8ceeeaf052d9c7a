"""The LM's KV-cache write: new keys or values into one layer's cache at
each row's length, with the int8 cache's running-absmax scales."""
