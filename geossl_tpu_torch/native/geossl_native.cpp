// geossl_native — C++ host runtime for the hot host-side paths (the port's
// copy of geossl_tpu/native/geossl_native.cpp: the same RNG and loop order,
// so that a seed gives the same mask bit for bit).
//
// The reference delegates these to native dependencies: PyG collate loops in
// C, torch_cluster's C++/CUDA radius search, networkx-based BFS masking
// (Python, slow — Geom3D/datasets/datasets_3D.py:24-67). Here they are one
// small C-ABI library loaded via ctypes (no pybind11 in this image):
//
//   * pack_batch      — fill padded [B, N] buffers straight from a MolStore's
//                       flat arrays (zero per-record Python objects)
//   * bfs_subgraph    — random-BFS kept-node selection (GeoSSL atom masking)
//   * radius_edges    — fixed-radius neighbor pairs for preprocessing caches
//
// Build: on first use by packing.py, g++ -O3 -march=native -shared -fPIC
// into native/_build/.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// SplitMix64 — deterministic, seedable, fast.
static inline uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

static inline uint64_t randbelow(uint64_t& s, uint64_t n) {
    return splitmix64(s) % n;  // modulo bias negligible for n << 2^64
}

// Pack selected molecules from flat store arrays into padded batch buffers.
// atom_flat: [sum_N] int32; pos_flat: [sum_N, 3] float; offsets: [M+1] int64;
// y_flat: [M, y_dim] float or nullptr; indices: [n_select] molecule ids.
// Outputs must be pre-zeroed or are fully overwritten here (we memset).
void pack_batch(const int32_t* atom_flat, const float* pos_flat,
                const int64_t* offsets, const float* y_flat, int64_t y_dim,
                const int64_t* indices, int64_t n_select,
                int64_t batch_size, int64_t n_max,
                int32_t* out_atom, float* out_pos, uint8_t* out_node_mask,
                uint8_t* out_graph_mask, float* out_y) {
    std::memset(out_atom, 0, sizeof(int32_t) * batch_size * n_max);
    std::memset(out_pos, 0, sizeof(float) * batch_size * n_max * 3);
    std::memset(out_node_mask, 0, batch_size * n_max);
    std::memset(out_graph_mask, 0, batch_size);
    if (out_y && y_flat) std::memset(out_y, 0, sizeof(float) * batch_size * y_dim);
    for (int64_t i = 0; i < n_select; ++i) {
        const int64_t mol = indices[i];
        const int64_t s = offsets[mol], e = offsets[mol + 1];
        const int64_t n = e - s;
        std::memcpy(out_atom + i * n_max, atom_flat + s, sizeof(int32_t) * n);
        std::memcpy(out_pos + i * n_max * 3, pos_flat + s * 3, sizeof(float) * n * 3);
        std::memset(out_node_mask + i * n_max, 1, n);
        out_graph_mask[i] = 1;
        if (out_y && y_flat)
            std::memcpy(out_y + i * y_dim, y_flat + mol * y_dim, sizeof(float) * y_dim);
    }
}

// Random-BFS kept-node selection (reference datasets_3D.py:24-44 semantics:
// grow until size > sub_num, uniform pick from the frontier set, random
// restart on empty frontier). Returns the kept count; out_keep gets the
// sorted kept indices. Frontier iteration over a sorted vector keeps the
// distribution identical to the reference's sorted-set choice.
int64_t bfs_subgraph(int64_t num_nodes, const int32_t* bond_src,
                     const int32_t* bond_dst, int64_t n_edges,
                     double mask_ratio, uint64_t seed, int64_t* out_keep) {
    if (num_nodes <= 0) return 0;
    const int64_t sub_num = (int64_t)(num_nodes * (1.0 - mask_ratio));
    // adjacency (CSR)
    std::vector<int32_t> deg(num_nodes, 0);
    for (int64_t k = 0; k < n_edges; ++k) deg[bond_src[k]]++;
    std::vector<int64_t> row(num_nodes + 1, 0);
    for (int64_t i = 0; i < num_nodes; ++i) row[i + 1] = row[i] + deg[i];
    std::vector<int32_t> col(n_edges);
    std::vector<int64_t> fill(row.begin(), row.end() - 1);
    for (int64_t k = 0; k < n_edges; ++k) col[fill[bond_src[k]]++] = bond_dst[k];

    uint64_t rng = seed ^ 0xda3e39cb94b95bdbULL;
    std::vector<uint8_t> in_sub(num_nodes, 0);
    std::vector<int32_t> frontier;  // kept sorted+unique
    std::vector<int64_t> kept;
    kept.reserve(num_nodes);

    auto add_frontier = [&](int32_t v) {
        if (in_sub[v]) return;
        auto it = std::lower_bound(frontier.begin(), frontier.end(), v);
        if (it == frontier.end() || *it != v) frontier.insert(it, v);
    };

    int32_t start = (int32_t)randbelow(rng, (uint64_t)num_nodes);
    kept.push_back(start);
    in_sub[start] = 1;
    for (int64_t k = row[start]; k < row[start + 1]; ++k) add_frontier(col[k]);

    while ((int64_t)kept.size() <= sub_num) {
        if (frontier.empty()) {
            int64_t remaining = num_nodes - (int64_t)kept.size();
            if (remaining == 0) break;
            int64_t pick = (int64_t)randbelow(rng, (uint64_t)remaining);
            for (int32_t v = 0; v < num_nodes; ++v) {
                if (!in_sub[v] && pick-- == 0) { frontier.push_back(v); break; }
            }
        }
        int32_t v = frontier[randbelow(rng, frontier.size())];
        frontier.erase(std::lower_bound(frontier.begin(), frontier.end(), v));
        if (in_sub[v]) continue;
        kept.push_back(v);
        in_sub[v] = 1;
        for (int64_t k = row[v]; k < row[v + 1]; ++k) add_frontier(col[k]);
    }
    std::sort(kept.begin(), kept.end());
    std::memcpy(out_keep, kept.data(), sizeof(int64_t) * kept.size());
    return (int64_t)kept.size();
}

// Fused BFS-mask + pack: for each selected molecule, run the random-BFS
// kept-node selection over its bond graph and gather the kept atoms straight
// into the padded batch buffers. This is the GeoSSL pretraining hot path
// (mask_ratio 0.3): doing it per-record in Python costs more host time than
// the training step it feeds.
void pack_batch_bfs(const int32_t* atom_flat, const float* pos_flat,
                    const int64_t* offsets,
                    const int32_t* bond_src_flat, const int32_t* bond_dst_flat,
                    const int64_t* bond_offsets,
                    const float* y_flat, int64_t y_dim,
                    const int64_t* indices, int64_t n_select,
                    int64_t batch_size, int64_t n_max,
                    double mask_ratio, uint64_t seed,
                    int32_t* out_atom, float* out_pos, uint8_t* out_node_mask,
                    uint8_t* out_graph_mask, float* out_y) {
    std::memset(out_atom, 0, sizeof(int32_t) * batch_size * n_max);
    std::memset(out_pos, 0, sizeof(float) * batch_size * n_max * 3);
    std::memset(out_node_mask, 0, batch_size * n_max);
    std::memset(out_graph_mask, 0, batch_size);
    if (out_y && y_flat) std::memset(out_y, 0, sizeof(float) * batch_size * y_dim);
    std::vector<int64_t> keep;
    uint64_t rng = seed ^ 0x9e3779b97f4a7c15ULL;
    for (int64_t i = 0; i < n_select; ++i) {
        const int64_t mol = indices[i];
        const int64_t s = offsets[mol], e = offsets[mol + 1];
        const int64_t n = e - s;
        out_graph_mask[i] = 1;
        int64_t kept_n;
        keep.resize(n);
        if (mask_ratio <= 0.0 || n <= 1) {
            kept_n = n;
            for (int64_t k = 0; k < n; ++k) keep[k] = k;
        } else {
            const int64_t bs = bond_offsets[mol], be = bond_offsets[mol + 1];
            kept_n = bfs_subgraph(n, bond_src_flat + bs, bond_dst_flat + bs,
                                  be - bs, mask_ratio, splitmix64(rng),
                                  keep.data());
        }
        for (int64_t k = 0; k < kept_n; ++k) {
            const int64_t src = s + keep[k];
            out_atom[i * n_max + k] = atom_flat[src];
            std::memcpy(out_pos + (i * n_max + k) * 3, pos_flat + src * 3,
                        sizeof(float) * 3);
            out_node_mask[i * n_max + k] = 1;
        }
        if (out_y && y_flat)
            std::memcpy(out_y + i * y_dim, y_flat + mol * y_dim,
                        sizeof(float) * y_dim);
    }
}

// ---- SDF V2000 shard scanner --------------------------------------------
//
// The offline Molecule3D featurizer's hot path: the reference re-parses the
// ~GB SDF shards with RDKit one molecule at a time
// (Geom3D/datasets/datasets_Molecule3D.py:61-75, hours for 3.9M molecules);
// the pure-Python fallback here (featurize.sdf_block_to_arrays) is faithful
// but similarly slow. This scanner walks a whole mmap'd shard in one call
// and emits the exact arrays featurize.sdf_block_to_arrays would: 9-way
// index-coded atom types, f32 positions, and both-direction bond pairs with
// 0-based kekulized types.

namespace {

struct Cursor {
    const char* p;
    const char* end;
};

inline bool next_line(Cursor& c, const char*& ls, const char*& le) {
    if (c.p >= c.end) return false;
    ls = c.p;
    const char* nl = (const char*)memchr(c.p, '\n', (size_t)(c.end - c.p));
    if (!nl) { le = c.end; c.p = c.end; }
    else     { le = nl;    c.p = nl + 1; }
    if (le > ls && le[-1] == '\r') --le;
    return true;
}

// Fixed-point decimal in [s, e) (SDF coords never carry exponents); returns
// false on garbage.
inline bool parse_fixed(const char* s, const char* e, float* out) {
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    if (s >= e) return false;
    bool neg = false;
    if (*s == '-') { neg = true; ++s; }
    else if (*s == '+') ++s;
    double v = 0.0;
    bool any = false;
    while (s < e && *s >= '0' && *s <= '9') { v = v * 10.0 + (*s - '0'); ++s; any = true; }
    if (s < e && *s == '.') {
        ++s;
        double scale = 0.1;
        while (s < e && *s >= '0' && *s <= '9') { v += (*s - '0') * scale; scale *= 0.1; ++s; any = true; }
    }
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    if (!any || s != e) return false;
    *out = (float)(neg ? -v : v);
    return true;
}

inline bool parse_int(const char* s, const char* e, long* out) {
    while (s < e && *s == ' ') ++s;
    if (s >= e) return false;
    bool neg = false;
    if (*s == '-') { neg = true; ++s; }
    long v = 0;
    bool any = false;
    while (s < e && *s >= '0' && *s <= '9') { v = v * 10 + (*s - '0'); ++s; any = true; }
    while (s < e && *s == ' ') ++s;
    if (!any || s != e) return false;
    *out = neg ? -v : v;
    return true;
}

// featurize.ATOMIC_NUM_LIST index code: {H,C,N,O,F,P,S,Cl} -> 0..7, every
// other symbol (known element or not) -> 8 (the unknown/mask token).
inline int32_t symbol_to_index(const char* s, const char* e) {
    while (s < e && *s == ' ') ++s;
    while (e > s && e[-1] == ' ') --e;
    const size_t n = (size_t)(e - s);
    if (n == 0 || n > 3) return 8;
    char a = (char)toupper(s[0]);
    char b = n > 1 ? (char)tolower(s[1]) : '\0';
    if (n == 1) {
        switch (a) {
            case 'H': return 0; case 'C': return 1; case 'N': return 2;
            case 'O': return 3; case 'F': return 4; case 'P': return 5;
            case 'S': return 6; default: return 8;
        }
    }
    if (n == 2 && a == 'C' && b == 'l') return 7;
    return 8;
}

}  // namespace

// Parse every $$$$-delimited V2000 block of an SDF shard into flat arrays
// (mmap'd single pass). Per block i: atoms land at
// [atom_offsets[i], atom_offsets[i+1]) of atom_type_flat/pos_flat, bonds
// (both directions, matching featurize.mol_to_arrays' (i,j),(j,i) order) at
// [bond_offsets[i], bond_offsets[i+1]) of bond_src/dst/type. ok[i]=0 marks
// an unparseable block (empty span) — the caller may re-parse it in Python
// via byte_offsets[i]..byte_offsets[i+1] (the block's file-byte span) while
// the index keeps advancing, preserving properties.csv row alignment. A
// trailing whitespace-only segment after the last $$$$ is NOT a block
// (matching structio.iter_sdf_blocks' any-content check).
// Returns #blocks, or -1 on IO error, -2 if a cap would overflow.
int64_t scan_sdf_file(const char* path,
                      int32_t* atom_type_flat, float* pos_flat,
                      int64_t atom_cap,
                      int32_t* bond_src, int32_t* bond_dst,
                      int32_t* bond_type, int64_t bond_cap,
                      int64_t* atom_offsets, int64_t* bond_offsets,
                      int64_t* byte_offsets,
                      uint8_t* ok, int64_t max_mols) {
    atom_offsets[0] = 0;
    bond_offsets[0] = 0;
    byte_offsets[0] = 0;
    const int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    const size_t size = (size_t)st.st_size;
    if (size == 0) { close(fd); return 0; }
    void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (map == MAP_FAILED) return -1;
    madvise(map, size, MADV_SEQUENTIAL);

    Cursor cur{(const char*)map, (const char*)map + size};
    const char* base = (const char*)map;
    int64_t n_mols = 0, n_atoms = 0, n_bonds = 0;
    const char *ls, *le;
    bool in_file = true;
    while (in_file) {
        // peek: end of file before any content -> done
        if (cur.p >= cur.end) break;
        if (n_mols >= max_mols) { munmap(map, size); return -2; }
        const int64_t a0 = n_atoms, b0 = n_bonds;
        bool good = true;
        bool saw_end = false;
        bool any_content = false;
        auto note_content = [&](const char* s, const char* e) {
            for (; s < e && !any_content; ++s)
                if (*s != ' ' && *s != '\t') any_content = true;
        };
        // a $$$$ anywhere terminates the current block (malformed blocks may
        // be shorter than their declared/structural line count)
        auto get_line = [&](const char*& gls, const char*& gle) -> bool {
            if (!next_line(cur, gls, gle)) return false;  // EOF
            if (gle - gls >= 4 && memcmp(gls, "$$$$", 4) == 0) {
                saw_end = true;
                return false;
            }
            note_content(gls, gle);
            return true;
        };
        // three header lines + counts line
        int got = 0;
        const char *cs = nullptr, *ce = nullptr;
        for (; got < 4 && get_line(ls, le); ++got) { cs = ls; ce = le; }
        if (got == 0 && !saw_end) break;  // clean EOF at a block boundary
        long na = 0, nb = 0;
        if (got < 4) {
            good = false;
        } else {
            // V3000 (counts line says "V3000") is not handled natively —
            // mark failed so the caller can fall back for this block.
            const size_t len = (size_t)(ce - cs);
            if (len >= 5 && memmem(cs, len, "V3000", 5) != nullptr) good = false;
            if (good && (!parse_int(cs, cs + std::min<size_t>(3, len), &na) ||
                         !parse_int(cs + 3, cs + std::min<size_t>(6, len), &nb) ||
                         na < 0 || nb < 0))
                good = false;
        }
        if (good && (n_atoms + na > atom_cap || n_bonds + 2 * nb > bond_cap)) {
            munmap(map, size);
            return -2;
        }
        if (good) {
            for (long i = 0; i < na; ++i) {
                if (!get_line(ls, le)) { good = false; break; }
                const size_t len = (size_t)(le - ls);
                float x, y, z;
                if (len < 30 ||
                    !parse_fixed(ls, ls + 10, &x) ||
                    !parse_fixed(ls + 10, ls + 20, &y) ||
                    !parse_fixed(ls + 20, ls + 30, &z)) { good = false; break; }
                pos_flat[(n_atoms) * 3 + 0] = x;
                pos_flat[(n_atoms) * 3 + 1] = y;
                pos_flat[(n_atoms) * 3 + 2] = z;
                atom_type_flat[n_atoms] =
                    symbol_to_index(ls + 31, ls + std::min<size_t>(34, len));
                ++n_atoms;
            }
        }
        if (good) {
            for (long e = 0; e < nb; ++e) {
                if (!get_line(ls, le)) { good = false; break; }
                long bi, bj, bt;
                if (le - ls < 9 ||
                    !parse_int(ls, ls + 3, &bi) ||
                    !parse_int(ls + 3, ls + 6, &bj) ||
                    !parse_int(ls + 6, ls + 9, &bt) ||
                    bi < 1 || bj < 1 || bi > na || bj > na) { good = false; break; }
                const int32_t t = (int32_t)std::min(std::max(bt, 1L), 4L) - 1;
                bond_src[n_bonds] = (int32_t)(bi - 1);
                bond_dst[n_bonds] = (int32_t)(bj - 1);
                bond_type[n_bonds] = t;
                ++n_bonds;
                bond_src[n_bonds] = (int32_t)(bj - 1);
                bond_dst[n_bonds] = (int32_t)(bi - 1);
                bond_type[n_bonds] = t;
                ++n_bonds;
            }
        }
        if (!good) { n_atoms = a0; n_bonds = b0; }
        // skip to the $$$$ terminator (or EOF)
        while (!saw_end && next_line(cur, ls, le)) {
            if (le - ls >= 4 && memcmp(ls, "$$$$", 4) == 0) { saw_end = true; break; }
            note_content(ls, le);
        }
        if (!saw_end) {
            in_file = false;  // trailing segment without terminator
            if (!any_content) break;  // whitespace-only tail: not a block
        }
        ok[n_mols] = good ? 1 : 0;
        ++n_mols;
        atom_offsets[n_mols] = n_atoms;
        bond_offsets[n_mols] = n_bonds;
        byte_offsets[n_mols] = (int64_t)(cur.p - base);
    }
    munmap(map, size);
    return n_mols;
}

// All ordered pairs (i, j), i != j, with |pos_i - pos_j| < r.
// Returns count; writes up to cap pairs.
int64_t radius_edges(const float* pos, int64_t n, double r,
                     int32_t* out_src, int32_t* out_dst, int64_t cap) {
    const double r2 = r * r;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = 0; j < n; ++j) {
            if (i == j) continue;
            const double dx = (double)pos[i * 3] - pos[j * 3];
            const double dy = (double)pos[i * 3 + 1] - pos[j * 3 + 1];
            const double dz = (double)pos[i * 3 + 2] - pos[j * 3 + 2];
            if (dx * dx + dy * dy + dz * dz < r2) {
                if (cnt < cap) { out_src[cnt] = (int32_t)i; out_dst[cnt] = (int32_t)j; }
                ++cnt;
            }
        }
    }
    return cnt;
}

}  // extern "C"
