"""Host runtime: media IO, frame streaming, stage timing."""
