"""Peak device memory the port allocated over set-up and window, GiB: an
end-to-end metric where the window's work has a fixed size."""
from benchkit.readers import peak_mem_gib as read  # noqa: F401
