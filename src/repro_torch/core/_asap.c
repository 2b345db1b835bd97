/* The sequential ASAP resource-serialisation core (pool binding).
 *
 * This is a literal port of the Python reference loop in
 * repro/core/schedule.py:_asap_scalar — same earliest-free-unit discipline
 * over the same packed (free_time * cap + unit_id) heaps, so the two are
 * bit-identical by construction (and proven so by the golden suite).  The
 * loop is inherently order-serial: each op's issue slot depends on every
 * earlier allocation in its pool, and measured wave-batching collapses to
 * ~1 op per wave on rank-major traces (each parallel instance's reduction
 * chain is contiguous in program order).  Hence a compiled kernel rather
 * than an array program.
 *
 * Built lazily by repro/core/cext.py with the system C compiler; the
 * Python loop remains the fallback when no compiler is available.
 *
 * Heap invariant (shared with the Python core): every acquire pops at most
 * one entry and pushes exactly one entry for the same unit, so a pool's
 * heap always holds exactly one entry per allocated unit; entries are
 * distinct because unit ids are distinct mod cap.  Pop order is therefore
 * implementation-independent (no ties), and any correct binary heap
 * reproduces heapq's sequence.
 */

#include <stdint.h>
#include <stdlib.h>

typedef int64_t i64;

static void heap_push(i64 *h, i64 *sz, i64 v) {
    i64 i = (*sz)++;
    h[i] = v;
    while (i > 0) {
        i64 p = (i - 1) >> 1;
        if (h[p] <= h[i])
            break;
        i64 tmp = h[p];
        h[p] = h[i];
        h[i] = tmp;
        i = p;
    }
}

static i64 heap_pop(i64 *h, i64 *sz) {
    i64 top = h[0];
    i64 last = h[--(*sz)];
    i64 n = *sz;
    i64 i = 0;
    for (;;) {
        i64 l = 2 * i + 1;
        if (l >= n)
            break;
        i64 r = l + 1;
        i64 m = (r < n && h[r] < h[l]) ? r : l;
        if (h[m] >= last)
            break;
        h[i] = h[m];
        i = m;
    }
    if (n > 0)
        h[i] = last;
    return top;
}

/* Returns 0 on success, 1 on allocation failure.
 *
 * start/key/ready/class_alloc/port_alloc are outputs; key must arrive
 * filled with -1, ready and the alloc arrays zeroed.  n_arrays may be 0
 * when no port-class ops exist (port_alloc then still needs 1 slot).
 */
int asap_pool(i64 n, i64 nv,
              const i64 *a0, const i64 *a1, const i64 *a2,
              const i64 *res, const i64 *dl, const i64 *ol,
              const i64 *cls, const i64 *aid,
              i64 n_classes, i64 cap_k, i64 ports_cap, i64 stride,
              i64 n_arrays, i64 port_class_id,
              i64 *start, i64 *key, i64 *ready,
              i64 *class_alloc, i64 *port_alloc) {
    /* heap entries per pool never exceed min(cap, n) */
    i64 cbuf = cap_k < n ? cap_k : n;
    if (cbuf < 1)
        cbuf = 1;
    i64 pbuf = ports_cap < n ? ports_cap : n;
    if (pbuf < 1)
        pbuf = 1;
    i64 *class_heap = malloc((size_t)(n_classes * cbuf) * sizeof(i64));
    i64 *class_sz = calloc((size_t)n_classes, sizeof(i64));
    i64 *port_heap = NULL;
    i64 *port_sz = NULL;
    if (n_arrays > 0) {
        port_heap = malloc((size_t)(n_arrays * pbuf) * sizeof(i64));
        port_sz = calloc((size_t)n_arrays, sizeof(i64));
    }
    if (!class_heap || !class_sz ||
        (n_arrays > 0 && (!port_heap || !port_sz))) {
        free(class_heap);
        free(class_sz);
        free(port_heap);
        free(port_sz);
        return 1;
    }

    for (i64 i = 0; i < n; i++) {
        i64 t = 0;
        i64 a = a0[i];
        if (a >= 0) {
            i64 ta = ready[a];
            if (ta > t)
                t = ta;
            a = a1[i];
            if (a >= 0) {
                ta = ready[a];
                if (ta > t)
                    t = ta;
                a = a2[i];
                if (a >= 0) {
                    ta = ready[a];
                    if (ta > t)
                        t = ta;
                }
            }
        }
        i64 cl = cls[i];
        if (cl) {
            i64 *h, *sz, *alloc, cap, key_base;
            if (cl == port_class_id) {
                i64 ar = aid[i];
                h = port_heap + ar * pbuf;
                sz = port_sz + ar;
                alloc = port_alloc + ar;
                cap = ports_cap;
                key_base = (n_classes + ar) * stride;
            } else {
                h = class_heap + cl * cbuf;
                sz = class_sz + cl;
                alloc = class_alloc + cl;
                cap = cap_k;
                key_base = cl * stride;
            }
            i64 uid;
            if (*sz > 0 && h[0] <= t * cap + cap - 1) {
                uid = heap_pop(h, sz) % cap;
            } else if (*alloc < cap) {
                uid = (*alloc)++;
            } else {
                i64 packed = heap_pop(h, sz);
                i64 fr = packed / cap;
                uid = packed % cap;
                if (fr > t)
                    t = fr;
            }
            heap_push(h, sz, (t + ol[i]) * cap + uid);
            key[i] = key_base + uid;
        }
        start[i] = t;
        i64 r = res[i];
        if (r >= 0)
            ready[r] = t + dl[i];
    }

    free(class_heap);
    free(class_sz);
    free(port_heap);
    free(port_sz);
    return 0;
}
