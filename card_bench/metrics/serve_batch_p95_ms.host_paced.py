"""95th percentile of batch latency (ms), from the `detect_batch` call to
the detections in host memory, over every request of the traced run's
window, where the requests are paced by the host's staging: at v11-n a
request (two batches, the pageable input copy serialized with the
forward) lasts about 120 ms, under the 250 ms a host-clock timing needs
to stand as an end-to-end metric, so it stands here, beside
serve_img_per_s."""


def read(ctx):
    return ctx.window.get("serve_batch_p95_ms")
