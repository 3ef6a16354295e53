// Native graph-batch packer — the host-side runtime component of this
// build (the counterpart of the reference's OctileGraph construction,
// graphdot/kernel/marginalized/_octilegraph.py:141-177, which packs sparse
// octiles for the CUDA kernel; here we pack dense padded batch arrays for
// the XLA/Pallas solver).
//
// Exposed through a plain C ABI and loaded via ctypes — no pybind11
// dependency. All outputs are caller-allocated, zero-initialized numpy
// buffers.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack B graphs' edge lists into padded dense adjacency matrices, degree
// vectors, node masks and directed edge lists in one pass.
//
//  n_nodes      [B]       node counts
//  edge_offsets [B+1]     prefix offsets into the concatenated edge arrays
//  ei, ej       [E_total] undirected edge endpoints (node indices)
//  ew           [E_total] edge weights
//  n_pad                  padded node count
//  m_pad                  padded directed-edge count
// outputs (zero-initialized by caller):
//  adj       [B, n_pad, n_pad]
//  degree    [B, n_pad]
//  node_mask [B, n_pad]
//  esrc, edst [B, m_pad] (int32)
//  ew_out    [B, m_pad]
//  n_edge    [B] directed edge counts
void pack_batch_f32(
    int32_t B,
    const int32_t* n_nodes,
    const int64_t* edge_offsets,
    const int32_t* ei,
    const int32_t* ej,
    const float* ew,
    int32_t n_pad,
    int32_t m_pad,
    float* adj,
    float* degree,
    float* node_mask,
    int32_t* esrc,
    int32_t* edst,
    float* ew_out,
    int32_t* n_edge)
{
    for (int32_t b = 0; b < B; ++b) {
        float* A = adj + (int64_t)b * n_pad * n_pad;
        float* D = degree + (int64_t)b * n_pad;
        float* M = node_mask + (int64_t)b * n_pad;
        int32_t* es = esrc + (int64_t)b * m_pad;
        int32_t* ed = edst + (int64_t)b * m_pad;
        float* wv = ew_out + (int64_t)b * m_pad;

        const int32_t n = n_nodes[b];
        for (int32_t k = 0; k < n; ++k) M[k] = 1.0f;

        int32_t m = 0;
        for (int64_t e = edge_offsets[b]; e < edge_offsets[b + 1]; ++e) {
            const int32_t i = ei[e], j = ej[e];
            const float w = ew[e];
            A[(int64_t)i * n_pad + j] = w;
            A[(int64_t)j * n_pad + i] = w;
            if (m < m_pad) {
                es[m] = i; ed[m] = j; wv[m] = w; ++m;
            }
            if (i != j && m < m_pad) {
                es[m] = j; ed[m] = i; wv[m] = w; ++m;
            }
        }
        n_edge[b] = m;
        for (int32_t i = 0; i < n; ++i) {
            float d = 0.0f;
            const float* row = A + (int64_t)i * n_pad;
            for (int32_t j = 0; j < n_pad; ++j) d += row[j];
            D[i] = d;
        }
    }
}

// Scatter a scalar edge-feature column into dense symmetric matrices and
// per-directed-edge lists (aligned with pack_batch_f32's edge order).
void pack_edge_feature_f32(
    int32_t B,
    const int64_t* edge_offsets,
    const int32_t* ei,
    const int32_t* ej,
    const float* values,
    int32_t n_pad,
    int32_t m_pad,
    float* mat,       // [B, n_pad, n_pad]
    float* elist)     // [B, m_pad]
{
    for (int32_t b = 0; b < B; ++b) {
        float* Mt = mat + (int64_t)b * n_pad * n_pad;
        float* L = elist + (int64_t)b * m_pad;
        int32_t m = 0;
        for (int64_t e = edge_offsets[b]; e < edge_offsets[b + 1]; ++e) {
            const int32_t i = ei[e], j = ej[e];
            const float v = values[e];
            Mt[(int64_t)i * n_pad + j] = v;
            Mt[(int64_t)j * n_pad + i] = v;
            if (m < m_pad) L[m++] = v;
            if (i != j && m < m_pad) L[m++] = v;
        }
    }
}

// Greedy size-bucketed scheduling of pair jobs: sorts job indices by the
// product cost n_i * n_j (descending) so fixed-size chunks have uniform
// CG convergence behavior — the static replacement for the reference's
// dynamic atomic job counter (template.cu:57-63).
void schedule_jobs_by_cost(
    int64_t n_jobs,
    const int32_t* i_idx,
    const int32_t* j_idx,
    const int32_t* n_nodes,
    int64_t* order)  // output permutation
{
    for (int64_t k = 0; k < n_jobs; ++k) order[k] = k;
    // insertion-free indirect sort: simple top-down merge sort on cost
    // (avoids <algorithm> closure plumbing for the C ABI)
    int64_t* tmp = new int64_t[n_jobs];
    auto cost = [&](int64_t k) -> int64_t {
        return (int64_t)n_nodes[i_idx[k]] * (int64_t)n_nodes[j_idx[k]];
    };
    for (int64_t width = 1; width < n_jobs; width *= 2) {
        for (int64_t lo = 0; lo < n_jobs; lo += 2 * width) {
            int64_t mid = lo + width < n_jobs ? lo + width : n_jobs;
            int64_t hi = lo + 2 * width < n_jobs ? lo + 2 * width
                                                 : n_jobs;
            int64_t a = lo, c = mid, o = lo;
            while (a < mid && c < hi) {
                if (cost(order[a]) >= cost(order[c])) tmp[o++] = order[a++];
                else tmp[o++] = order[c++];
            }
            while (a < mid) tmp[o++] = order[a++];
            while (c < hi) tmp[o++] = order[c++];
            memcpy(order + lo, tmp + lo, (hi - lo) * sizeof(int64_t));
        }
    }
    delete[] tmp;
}

}  // extern "C"
